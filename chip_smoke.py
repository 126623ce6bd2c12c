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
   128), qwen2-moe-a2.7b (1, 4096, 16 / 16, 128), kimi-k2 (1, 4096,
   64 / 8, 112), llava-next-34b (1, 4096, 56 / 8, 128) and musicgen-large
   (4, 1536, 32 / 32, 64), SDPA beside each); f32 at the recurrentgemma-2b
   shape (SDPA beside it) and gemma2-2b's global layer; untimed edge cases
   (a ragged S, G = 3 and G = 130, Dh 32, 128 and 256, softcap with a
   window, a window under a key tile, Dh 112 in both dtypes,
   musicgen-large's 30 s of frames (4, 1500, 32 / 32, 64), a ragged S);
   each timed row with its TFLOP/s and bound share at its route's peak
   (f32 rows also at split TF32's 165 TFLOP/s);
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
   and mean), a measurement;
16. xlstm-1.3b at full width (bf16, random weights from seed 0, 42 mLSTM
   and 6 sLSTM layers; no kernel of its own): (a) served whole through
   ``serve.generate`` (batch 1, prompt 4096 = four mLSTM chunks of 1024,
   8 new tokens, greedy) with prefill seconds (first, then steady, and
   the sLSTM layers' share of a prefill on a synchronised clock), decode
   ms per step, new tokens per second, peak memory and the exit head's
   statistics; its prefill must launch no K5 and no K6; (b) one fedhen
   flat round on the LM cell's settings (``lm_cell``: 8 clients at 0.25,
   batch 2, 4 sequences a client, ``synthetic_lm`` over 4,096 ids, the
   f32 wire) on sequences of 1024 inputs, then a second round traced for
   the device's busy time and idle share, each with wall, losses, eval,
   bytes against the closed form and peak, K1 launched once a fold; one
   sLSTM layer's forward and backward at the round's shape, timed; K1 at
   the cell's fold (N = n_flat = 1,883,654,144) bitwise against its plain
   version and timed beside its byte bound;
17. llava-next-34b and musicgen-large at full width (bf16, random weights
   from seed 0, no cut): (a) llava-next-34b whole (33.9 G parameters,
   63.2 GiB) through ``serve.generate`` text-only, as ``serve.main``
   serves it (batch 1, prompt 4096, 8 new tokens, greedy), first and
   steady prefill, then on the same params one prefill of 2880
   ``synthetic_frontend_embeds`` patch rows and 1216 text tokens (4096
   positions, a cache of 4104), first and steady, and 7 greedy decode
   steps from position 4096; every prefill launching the tensor-core K5
   once a layer (60), decode none; (b) musicgen-large whole through
   ``serve.generate`` at batch 4 on a prompt of 1536 frames x 4 codebooks
   (MusicGen's 30 s at 50 Hz, rounded up to the prefill's 512-position
   chunks), 32 new frames, with the exit head's agreement over every
   codebook; 48 K5 launches a prefill; (c) one fedhen flat round of
   musicgen-large at full width on the LM cell's settings on sequences of
   512 frames x 4 codebooks, then one traced (busy, idle share), with
   wall, losses, eval, bytes against the closed form and peak, K1 once a
   fold; K1 at the cell's fold (N = n_flat = 2,434,994,176 > 2**31)
   bitwise against its plain version and timed beside its byte bound;
   (d) narrow, card against CPU: reduced musicgen-large (with its
   conditioning rows) and reduced llava-next-34b (text-only, and with its
   patch rows through prefill) served in f32 at rtol 1e-4 / atol 1e-5 and
   in bf16 within 5 % of max|logit|, each card run launching its dtype's
   K5 once a layer a prefill, and in f32 the card's prefill and decode
   against its prefill of the whole sequence; one narrow fedhen round of
   each (llava's shards carrying their patch rows) at phase 10's rules;
18. the launch-side step functions (``repro_torch.launch.steps``): (a)
   ``make_fed_round_step`` on Gemma-2 2B at full width (bf16, weights from
   seed 0 drawn on the card, one model ``expand``-ed to a cohort of 4: 2
   simple, 2 complex), ``cohort_chunk`` 1, batch 2, 2 local steps, the LM
   cell's sequences of 512 tokens, the flat mask passed in: once on the
   f32 wire (K1 4 times), once on the int8 wire (K2 4 times), each with
   its synchronised wall, peak and loss, the int8 round held to the f32
   one by ``tests/test_fedround.py``'s rule (loss at rtol 1e-5, every
   leaf within max|f32 leaf| / 100); K2 (new at this N) and K1 at the
   fold's shape (Z = 1, N = 2,614,224,896 > 2**31) bitwise against their
   plain versions and timed beside their byte bounds; (b) the narrow
   cases of ``tests/test_torch_steps*.py`` (flat f32 at chunk 1, 2 and 4,
   int8, the tree engine through K4, decouple, staleness, a pad slot, a
   NaN client, B < local_steps) on the card against the port's CPU result
   at rtol 1e-4 / atol 1e-5 (int8 under ``repro_torch.parity``'s rules);
   (c) ``aggregate.make_engine`` on the card, an EngineSpec against the
   deprecated loose form, bitwise; (d) gemma3-4b trained at full width in
   the LM cell's settings (two fedhen rounds, the second traced), its
   peak printed, K1 at its fold (n_flat above 2**31) bitwise and timed;
   (e) ``examples/quickstart_torch.py``'s three algorithms, 36 rounds
   each, and its rounds-to-target table (not gated);
19. the scale-out layer (``repro_torch.launch.mesh`` / ``sharding``, one
   default process group, NCCL for the card and gloo for the CPU, world
   size 1, destroyed at the end of the phase): (a)
   ``make_fed_round_step(cfg, MeshPolicy(make_device_mesh(1, 1, "cuda"),
   cfg), ...)`` at phase 18(a)'s settings on the f32 wire (K1 4 times)
   and the int8 wire (K2 4 times), each round's new model and loss
   bitwise phase 18(a)'s unsharded round, one all-reduce a round of the
   engine state and the loss sum (4 n_flat + 12 bytes), its device time
   (CUDA events around it), the wall and the peak; (b) the narrow sharded
   step on the flat and tree engines, the card's mesh against the CPU's
   at rtol 1e-4 / atol 1e-5 (K1 2, K4 2); (c)
   ``attention.chunk2d_attention`` in bf16 (q_chunk 512, k_chunk 2048) at
   llava-next-34b's shape (1, 4096, 56 / 8, 128) and gemma2-2b's windowed
   layer (1, 8192, 8 / 4, 256, window 4096, softcap 50), each within 5 %
   of max|out| of the tensor-core K5 on the same inputs, each element
   within 2**-4 of its magnitude plus 2**-8 and each (row, head) within
   2**-6 of its L2 norm, both timed; (d) one round of the LM cell with
   telemetry on: its ``roofline`` ledger (flops > 0; the walk's kernel
   counters exactly the round's two K1 folds, calls, flops and bytes, and
   hbm_bytes at least those bytes), the new model bitwise the
   telemetry-off round's, the walk's added wall;
20. a live model axis (tensor parallelism): phase 18(a)'s unsharded
   rounds saved to a temporary directory, then two rank processes
   (``torch.multiprocessing``, one ``FileStore``) share the card over gloo
   in a (1, 2) mesh (NCCL refuses two ranks on one device; on CUDA
   tensors gloo's functional all-gather crashes, so every path here issues
   all-reduces only), each printing its wall, peak, launches and
   collectives (count and result bytes): (a) phase 18(a)'s round under
   ``MeshPolicy`` of that mesh (``distribute_cohort`` of the expanded
   model; K1 4 on the f32 wire, K2 4 on int8, on the rank's local
   n_flat), each local leaf within 5 % of max|leaf| of the unsharded
   round's (the leaves over 1/100 counted) and the loss at rtol 1e-2;
   (b) minitron-8b prefilled at published widths, 8 of its 32 layers
   (batch 1, prompt 4096; K5 8 on 16 of 32 heads), (c) recurrentgemma-2b
   whole (batch 4, prompt 4096;
   K6's gated entry 18 on 1280 of 2560 channels, K5 8 replicated) and
   (e) gemma2-2b (batch 1, prompt 8192; K5 26 replicated), each then
   served on its sharded cache through ``make_serve_step(...,
   with_exit_head=True)``: 7 steps (8 new tokens) each on
   minitron's heads, recurrentgemma's ring of 2048 over kv_seq and its
   RG-LRU state over 1280 channels, gemma2's dense global cache of 8200
   slots and ring of 4096 over kv_seq, fed the unsharded run's greedy
   tokens; each rank's vocab shard of the prefill logits and of each
   step's logits and exit logits within 5 % of max|logit| of the
   unsharded prefill and decode of the same weights (run first on the
   rank, not counted), with the decode ms a step, the collectives a step
   and the peak, no kernel launched in decode and no all-gather issued;
   (d) a narrow f32 round (flat and tree) and prefill on the
   card's mesh against the CPU's in the same processes at rtol 1e-4 /
   atol 1e-5 (K1 1, K4 1, K5 f32 2 a rank).  The MoE configs: (f)
   qwen2-moe-a2.7b at published widths, 6 of its 24 layers (30 of 60
   experts and 8 of 16 heads a rank; K5 6) and (g) kimi-k2-1t-a32b at
   published widths cut to 1 layer (192 of
   384 experts, 32 of 64 heads; K5 1), each batch 1, prompt 4096, then 7
   serve steps with the exit head: the ranks build the full model in
   turn, each serves it unsharded first and records every MoE call's
   router logits, keeps its shards, and the sharded run routes from those
   logits (its slots equal to the unsharded run's; the pairs its own
   logits would have moved are printed); the logits, exit logits, peaks
   and collectives as in (b); (h) reduced qwen2-moe's train step and its
   f32 and int8 rounds on the card's mesh against the CPU's (K1 1, K2 1 a
   rank).  The xLSTM and codebook configs at published widths: (i)
   xlstm-1.3b, one period of its six (7 mLSTM and 1 sLSTM layers; batch
   1, prompt 4096; every mixer whole on each rank's rows, no K5 or K6; the
   cache's C, n and conv split over model) and (j) musicgen-large, 12 of
   its 48 layers (batch 4, 64 conditioning rows then 1472 frames of 4
   codebooks; 16 of 32 heads and 1024 of 2048 rows of each codebook table
   a rank; K5 12),
   each then 7 serve steps with the exit head, checked and printed as in
   (b), the logits compared on each rank's share as the reference's
   constrain places them (xlstm's vocab rows, musicgen's codebooks); (k)
   reduced xlstm-1.3b and musicgen-large's train step, f32 and int8
   rounds, prefill and 4 serve steps on the card's mesh against the CPU's
   (K1 2, K2 2, K5 f32 2 a rank; xlstm's training with its sLSTM output
   in f32 on both sides, its logits within 5 %).  The token splits: (l)
   gemma2-2b under seq2d (batch 1, prompt 8192, each rank's 4096 query
   rows, K5's query-offset entry on rank 1) and (m) under dp2d (batch 2,
   a sequence a rank), each then 7 serve steps, checked as (b); (n)
   reduced gemma2-2b under seq2d and dp2d and reduced llava-next-34b
   under seq2d_fsdp, train, rounds, prefill and serve, card against CPU;
   (o) recurrentgemma-2b under seq2d (batch 4, prompt 4096, each rank's
   2048 rows: the RG-LRU layers' conv halo gathered and K6's carried
   entry on each rank, rank 1 from rank 0's f32 ``y_last``, 18 a rank;
   the local attention on K5's query-offset entry on rank 1) then 7
   serve steps on the kv_seq ring and the channel-split RG-LRU state,
   checked as (b); (p) reduced recurrentgemma-2b and musicgen-large
   under seq2d and dp2d, train, f32 / int8 / tree rounds, a 256-position
   prefill and 6 serve steps, card against CPU; (q) (n)'s narrow f32 /
   int8 / tree rounds over the two ranks as a (2, 1, 1) ("pod", "data",
   "model") mesh, bitwise the same over a (2, 1) ("data", "model") mesh
   and held to the CPU's pod mesh.  The MoE token splits: (r)
   qwen2-moe-a2.7b at published widths, 6 of its 24 layers, under seq2d
   (batch 1, prompt 4096, each rank's 2048 rows: each MoE layer's routing
   groups split over the ranks, the whole sequence's capacity, rank 1's
   queue places after rank 0's pairs; K5's query-offset entry on rank 1)
   then 7 serve steps, the ranks building in turn and each rank's MoE
   calls replaying the unsharded run's router logits sliced to its rows,
   its slots the unsharded run's for its tokens less the offsets, the
   pairs it drops only because of rank 0's counts printed, checked as
   (b); (s) reduced qwen2-moe (capacity factor 1.0, the pairs rank 1
   drops that its own routing would keep printed) and kimi-k2 under
   seq2d, dp2d and seq2d_fsdp, train (aux losses in the loss), qwen2-moe's
   f32 / int8 / tree rounds, a 256-position prefill and 6 serve steps,
   card against CPU; (t) the two ranks as a (2, 1) mesh: reduced
   qwen2-moe's prefill and 6 serve steps (decode's routing group split
   over data, routed with queue offsets), reduced kimi-k2's 2-D experts
   (gathered over data by all-reduces) in its train step, prefill and
   serve steps, card against CPU, all-reduces only.  Then, the card to
   itself: K2 and K1
   at a rank's local n_flat (1,491,200,000) bitwise and timed against
   their byte bounds, K5 at a rank's heads (minitron (1, 4096, 16 / 4,
   128), qwen2-moe (1, 4096, 8 / 8, 128), kimi-k2 (1, 4096, 32 / 4, 112),
   musicgen-large (4, 1536, 16 / 16, 64)) and on a rank's query rows
   (gemma2-2b's, recurrentgemma-2b's (4, 2048 at 2048, 10 / 1, 256,
   window 2048), qwen2-moe-a2.7b's (1, 2048 at 2048, 16 / 16, 128)),
   K6's gated entry at a rank's channels (4, 4096, 1280),
   each against its plain version and timed against its bound; and K6's
   carried entry: at (4, 4096, 2560) bf16 the launch cut at row 2048, the
   second half run from the first's ``y_last``, bitwise the whole launch
   (rows and ``y_last``), then timed at a rank's rows (4, 2048, 2560)
   against its bound and the unfused composition.

Phase 8 also serves reduced xlstm-1.3b in f32 on the card against the CPU
(prefill and 8 teacher-forced decode steps): the sLSTM cell output before
``_slstm_out``'s bf16 cast, and the caches, at rtol 1e-4 / atol 1e-5; the
logits, downstream of that cast, within 5 % of max|logit|; no K5 or K6.
Phase 10 also runs its round: updates within bf16 rounding and losses at
rtol 1e-4 with the cast, and with the sLSTM FFN kept in f32 on both sides
server params at rtol 1e-4 / atol 1e-5.

Kernel times are device times (``time_ms``: a CUDA graph of the timed
calls between two events, so the host's launch rate does not enter).  The
second-to-last line is one JSON object ``{"kernels": [...]}`` (K1-K4,
both K5 kernels, K6's two entries; K1 and K4 with their launches on the
LM path of phase 9 beside phase 4's, and their LM-shape times; K1-K4 with
their launches on phase 11's async path, K5 and K6 with theirs on phase
12's serving from checkpoints; K1-K4 with their launches on phase 13's
telemetry path, the tensor-core K5 with its serving of the trained model
there and its launches in phase 14's dense serving and phase 15's MoE
serving; K1 with its launches on phase 16's xLSTM rounds and its time at
xLSTM's fold; K1 with its launches on phase 17's musicgen-large rounds and
its time at that fold, the tensor-core K5 with its launches serving
llava-next-34b and musicgen-large, both K5 kernels with their launches in
phase 17's narrow serving; K1 and K2 with their launches on phase 18's
full-width step rounds, K1, K2 and K4 with theirs on its narrow steps, K2
with its time at that fold, K1 with its launches on gemma3-4b's rounds
and the quickstart and its time at gemma3-4b's fold; K1 and K2 with their
launches on phase 19's sharded step rounds, K1 and K4 with theirs on its
narrow sharded steps, K1 with its launches on its telemetry-on round;
K1, K2, K4, both K5 kernels and K6 with their launches over both ranks of
phase 20, and K1, K2, the tensor-core K5 and K6 with their times at the
shapes a rank hands them; K5's query-offset entry and K6's carried entry
with their launches on phase 20's token splits and their times at a
rank's rows, K5's also at qwen2-moe-a2.7b's rank-1 rows with its launches
in (r)); the last is
``{"ok": true, "device": {...}}``.
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


def count_true(mask) -> int:
    """Elements set in a bool vector, summed a slice at a time: ``sum``
    widens bool to int64, 29 GiB at once for gemma3-4b's mask."""
    return sum(int(mask[a:a + LM_SLICE].sum())
               for a in range(0, mask.numel(), LM_SLICE))


def fold_bytes(torch, mask, w_m, w_rest, row_bytes) -> int:
    """The least bytes a dense accumulating fold (K1, K2) moves for these
    weights: acc read (4N) and the mask (N); each row's payload where its
    weight is live, ``row_bytes(live inside M, live outside M)``; and acc
    written, 4 bytes for each element that a live row changes.  Counted
    from the mask and the weights, never from the output."""
    n, n_m = mask.numel(), count_true(mask)
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
    ("llava-next-34b prefill", 1, 4096, 56, 8, 128, 0, 0.0, "bfloat16",
     True),
    ("musicgen-large prefill", 4, 1536, 32, 32, 64, 0, 0.0, "bfloat16",
     True),
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
    ("musicgen-large, 30 s ragged bf16", 4, 1500, 32, 32, 64, 0, 0.0,
     "bfloat16", False),
)
# (route, peak the bound counts, peak of a second share): f32 stays on the
# CUDA cores (67 TFLOP/s); split TF32 on the tensor cores (TF32_SPLIT_PEAK,
# 495 / 3 = 165 TFLOP/s of f32 products) could not hold the f32 tolerance
# (``launch/tune_flash.py``), and the second share is against that rate
FLASH_ROUTES = {"bfloat16": ("tensor cores (wgmma)", BF16_PEAK, None),
                "float32": ("CUDA cores", F32_PEAK, TF32_SPLIT_PEAK)}


def check_flash(torch, bw: float, cases=FLASH_CASES) -> dict:
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
    for label, b, s, h, kh, dh, window, cap, dtype, timed in cases:
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
        pairs = ops.causal_pairs(s, window)
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


def check_scan(torch, bw: float, scan_cases=SCAN_CASES,
               gated_cases=GATED_CASES) -> dict:
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

    for b, s, d, dtype, timed in scan_cases:
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
    for b, s, d, dtype, with_y0, timed in gated_cases:
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


# K6's carried entry (y0 in, y_last out) on a rank's rows of phase 20(o):
# recurrentgemma-2b's prefill shape cut at row 2048, the second rank's
# half run from the first's f32 state
K6_RANK = (4, 2048, 2560)


def carried_composition(p: dict, x, y0):
    """What the carried gated entry replaces, unfused: ``rglru._gates``,
    y0 folded into the first step, K6's plain entry, the cast to x's
    dtype and the f32 last row."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.models import rglru
    a, b = rglru._gates(p, x)
    b[:, 0] = b[:, 0] + a[:, 0] * y0
    y = ops.lru_scan(a, b)
    return y.to(x.dtype), y[:, -1]


def check_scan_carry(torch, bw: float) -> dict:
    """K6's gated entry with its carry, on the card.  At the path's shape
    ``K6_PATH`` in bf16: the whole launch with ``y_last`` bitwise the
    launch without it and the plain version (y and y_last); the launch cut
    at row 2048, the second half run from the first half's ``y_last``,
    bitwise rows 2048-4095 of the whole launch, and its ``y_last`` the
    whole launch's; the second half run from the first half's last bf16
    row instead (not the state) is not.  Each call checked to launch the
    gated entry once (``launches_carry`` where it gives out y_last).  Then
    timed at a rank's rows ``K6_RANK`` (y0 in, y_last out) beside its
    bound (x read and y written in bf16, the vectors, y0 and y_last, at
    the HBM rate; the gate math's FP32 and MUFU instructions from the
    SASS at the issue rates) and the unfused composition
    (:func:`carried_composition`)."""
    from repro_torch.kernels.rglru_scan import ops, ref
    b, s, d = K6_PATH
    cut = K6_RANK[1]
    x, p, _ = gate_inputs(torch, b, s, d, torch.bfloat16, seed=23)
    c = -8.0 * torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    vecs = (p["w_r"], p["b_r"], p["w_i"], p["b_i"], c)

    def state():
        return torch.empty((b, d), dtype=torch.float32, device="cuda")

    def launch(xx, y0=None, y_last=None):
        fn = ops.lru_scan_gated
        before = (fn.launches, fn.launches_carry)
        y = fn(xx, *vecs, y0, y_last)
        if (fn.launches, fn.launches_carry) != (
                before[0] + 1, before[1] + int(y_last is not None)):
            raise RuntimeError("lru_scan_gated: the carried entry not "
                               "launched once")
        return y
    last = state()
    whole = launch(x, None, last)
    _equal(torch, f"lru_scan_gated {K6_PATH} bf16 x with y_last: y against "
           f"the launch without it", whole, launch(x))
    want_last = state()
    _equal(torch, f"lru_scan_gated {K6_PATH} bf16 x with y_last: y", whole,
           ref.lru_scan_gated_ref(x, *vecs, None, want_last))
    _equal(torch, f"lru_scan_gated {K6_PATH} bf16 x: y_last", last,
           want_last)
    first_last, second_last = state(), state()
    first = launch(x[:, :cut].contiguous(), None, first_last)
    second = launch(x[:, cut:].contiguous(), first_last, second_last)
    _equal(torch, f"rows 0-{cut - 1} against the whole launch's", first,
           whole[:, :cut])
    _equal(torch, f"rows {cut}-{s - 1} from rows 0-{cut - 1}'s y_last "
           f"against the whole launch's", second, whole[:, cut:])
    _equal(torch, f"y_last after rows {cut}-{s - 1} against the whole "
           f"launch's", second_last, last)
    from_row = launch(x[:, cut:].contiguous(),
                      first[:, -1].float().contiguous())
    torch.cuda.synchronize()
    row_differs = not torch.equal(from_row, whole[:, cut:])
    if not row_differs:
        raise RuntimeError("K6 from the last bf16 row equals the run from "
                           "the f32 state: the check cannot tell them "
                           "apart")
    print(f"  the second half from rows 0-{cut - 1}'s last bf16 row instead "
          f"of y_last: {int((from_row != whole[:, cut:]).sum()):,} of "
          f"{from_row.numel():,} outputs differ", flush=True)
    del whole, first, second, from_row, want_last
    xr = x[:, cut:].contiguous()
    y0, y_last = first_last, state()
    args = (xr, *vecs, y0, y_last)
    counted = gate_ops(torch)
    n = xr.numel()
    nbytes = 2 * n * xr.element_size() + 5 * d * 4 + 2 * b * d * 4
    bytes_ms = nbytes / bw * 1e3
    f32_ms = n * counted["fp32_per_element"] / F32_ISSUE * 1e3
    mufu_ms = n * counted["mufu_per_element"] / MUFU_RATE * 1e3
    bound_ms = max(bytes_ms, f32_ms, mufu_ms)
    ms = time_ms(torch, lambda: ops.lru_scan_gated(*args), iters=20,
                 warmup=3)
    plain_ms = time_ms(torch, lambda: ref.lru_scan_gated_ref(*args),
                       iters=2, warmup=1)
    library_ms = time_ms(torch, lambda: carried_composition(p, xr, y0),
                         iters=10, warmup=2)
    got, got_last = ops.lru_scan_gated(*args), y_last.clone()
    want, want_last = carried_composition(p, xr, y0)
    _equal(torch, f"lru_scan_gated {K6_RANK} bf16 x, y0 and y_last, "
           f"against the unfused composition", got, want)
    _equal(torch, f"lru_scan_gated {K6_RANK}: y_last against the "
           f"composition's", got_last, want_last)
    row = {"entry": "lru_scan_gated (carried)",
           "shape": {"B": b, "S": cut, "D": d, "dtype": "bfloat16",
                     "y0": True, "y_last": True},
           "ms": ms, "plain_ms": plain_ms, "bytes_needed": nbytes,
           "bytes_ms": bytes_ms, "fp32_ms": f32_ms, "mufu_ms": mufu_ms,
           "bound_ms": bound_ms, "bound_share": bound_ms / ms,
           "bound_by": "bytes" if bytes_ms >= max(f32_ms, mufu_ms)
           else "operations", "library_ms": library_ms,
           "speedup_over_library": library_ms / ms,
           "row_carry_differs": row_differs, **counted}
    print(f"  lru_scan_gated carried {K6_RANK} bf16 x: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes "
          f"{bytes_ms:.4f}, FP32 issue {f32_ms:.4f}, MUFU {mufu_ms:.4f}), "
          f"bound share {bound_ms / ms:.3f}; the unfused composition "
          f"{library_ms:.4f} ms ({library_ms / ms:.2f}x the kernel)",
          flush=True)
    return {"max_abs_err": 0.0, "timing": [row]}


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


def serving(torch, runs=SERVE_RUNS, steady: bool = False) -> dict:
    """Phases 7, 14, 15, 16 and 17: full-width serving through
    ``serve.generate``.  Launch counts are zeroed before each run, read
    when prefill is done and again at the end.  A multi-codebook config
    serves (batch, prompt, n_codebooks) prompts.  A run of an MoE config
    also prints its prefill's routing: pairs dropped at capacity and
    tokens an expert (a measurement, not a gate).  ``steady`` adds each
    run's steady prefill (``_steady_prefill``)."""
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
        codebooks = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        prompts = torch.randint(0, cfg.vocab_size,
                                (batch, prompt) + codebooks, device="cuda",
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
        if tuple(tokens.shape) != (batch, prompt + gen) + codebooks or \
                not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
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
        if steady:
            row.update(_steady_prefill(torch, params, cfg, prompts, counts,
                                       prefill_counts))
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
    the list of its calls, each {logits, slot_idx, experts, slot, top_k,
    start}, kept where the run made them (no copy, no sync).  With
    ``replay`` (an earlier run's calls) each call routes from that run's
    router logits instead of its own, records that routing as
    ``replayed``, and still records the routing its own logits give.  A
    call on a rank's part of a routing group split over ranks (a token
    split's rows) replays the rows of that group it holds: ``start``, its
    first token, is its place among the ranks times its token count (the
    ranks' parts are equal here)."""
    from repro_torch.models import mlp
    route, calls = mlp._route, []

    def record(r, logits, start):
        return {"logits": logits, "slot_idx": r.slot_idx,
                "experts": r.token_expert, "slot": r.token_slot,
                "top_k": r.token_expert.shape[-1], "start": start}

    def wrapped(logits, moe, capacity, e_pad=0, group=None):
        own = route(logits, moe, capacity, e_pad, group)
        s = logits.shape[1]
        start = group.place() * s if group is not None and group.dims else 0
        calls.append(record(own, logits, start))
        if replay is None:
            return own
        theirs_logits = replay[len(calls) - 1]["logits"][
            :, start:start + s].to(logits.device)
        theirs = route(theirs_logits, moe, capacity, e_pad, group)
        calls[-1]["replayed"] = record(theirs, theirs_logits, start)
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


def check_folds_lm(torch, ops, ref, bw: float, layout, mask,
                   keys=("k1", "k4")) -> dict:
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
    time.  ``keys`` picks the kernels ("k1", "k4")."""
    n = mask.numel()
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((1, n), generator=g, device="cuda")
    acc0 = torch.randn((n,), generator=g, device="cuda")
    n_m = count_true(mask)
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
        if key not in keys:
            del out[key]
            continue
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


# Phases 8, 10 and 16: xLSTM (models/xlstm.py).  It has no kernel of its
# own: its prefill must launch neither K5 nor K6, and its round folds
# through K1.
XLSTM = "xlstm-1.3b"
# (arch, batch, prompt, new tokens, launches of one prefill: K5 on the
#  tensor cores, K5 on the CUDA cores, K6); the prompt is four of the
#  published mlstm_chunk (1024)
XLSTM_SERVE_RUNS = (("xlstm-1.3b", 1, 4096, 8, (0, 0, 0)),)


@contextlib.contextmanager
def _slstm_hs():
    """Record the f32 cell output each ``xlstm._slstm_out`` call gets,
    before its bf16 cast (on the CPU, as a copy)."""
    from repro_torch.models import xlstm
    seen, out = [], xlstm._slstm_out

    def rec(p, hs, cfg):
        seen.append(hs.detach().float().cpu())
        return out(p, hs, cfg)
    xlstm._slstm_out = rec
    try:
        yield seen
    finally:
        xlstm._slstm_out = out


@contextlib.contextmanager
def _f32_slstm_out():
    """``xlstm._slstm_out`` without its bf16 cast: the norm and the FFN in
    the cell output's own dtype (f32 in the reduced config), so that a
    card-vs-CPU comparison of a round sees the f32 arithmetic alone."""
    from repro_torch.models import common, xlstm
    from repro_torch.models.mlp import gelu
    out = xlstm._slstm_out

    def f32_out(p, hs, cfg):
        b, s, nh, dh = hs.shape
        h = common.apply_rmsnorm(p["norm"], hs, cfg.norm_eps).reshape(
            b, s, nh * dh)
        g = h @ p["ff_gate"].to(h.dtype)
        return gelu(g) @ p["ff_down"].to(h.dtype)
    xlstm._slstm_out = f32_out
    try:
        yield
    finally:
        xlstm._slstm_out = out


def xlstm_serving_card_vs_cpu(torch) -> tuple:
    """Phase 8's xLSTM rows: reduced xlstm-1.3b in f32 (one mLSTM and one
    sLSTM layer, chunk 8), prefill of 64 tokens and 8 teacher-forced
    decode steps (final and exit heads) on the card against the CPU.  Two
    rules, each for its tensors: the sLSTM cell output before
    ``_slstm_out``'s bf16 cast (every call: the prefill's and each
    step's), and the decode caches, at rtol 1e-4 / atol 1e-5; the logits,
    downstream of that cast (a one-ulp f32 difference can flip a bf16
    rounding), within 5 % of max|logit| (the bf16 serving rule).  The
    card's prefill and decode launch neither K5 nor K6.  Then the card's
    decode, token by token from an empty cache, against its own prefill
    at the reference test's 6e-3.  Returns (max|diff| of the cell outputs,
    of the logits)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rglru_scan.ops import lru_scan, lru_scan_gated
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map
    rtol, atol = 1e-4, 1e-5
    prompt, steps, batch = 64, 8, 2
    cfg = configs.get_reduced(XLSTM)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt + steps),
                           generator=torch.Generator().manual_seed(1))
    sides = {}

    def launches():
        return (flash_attention.launches_tc + flash_attention.launches,
                lru_scan.launches + lru_scan_gated.launches)
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda x: x.to(dev), params)
        toks = tokens.to(dev)
        before = launches()
        with torch.inference_mode(), _slstm_hs() as hs:
            logits, cache = tfm.prefill(p, cfg, toks[:, :prompt],
                                        cache_len=prompt + steps)
            outs = [logits]
            for t in range(prompt, prompt + steps):
                lg, cache, ex = tfm.decode_step(p, cache, cfg,
                                                toks[:, t:t + 1], t,
                                                with_exit_head=True)
                outs += [lg, ex]
        sides[dev] = ([o.cpu().float() for o in outs], list(hs),
                      [x.cpu().float() for x in tree_leaves(cache)])
        if launches() != before:
            raise RuntimeError(f"{XLSTM} narrow on {dev}: K5/K6 launched")
    worst_hs = worst_cache = worst_lg = 0.0
    for c, h in zip(sides["cuda"][1] + sides["cuda"][2],
                    sides["cpu"][1] + sides["cpu"][2]):
        diff = (c - h).abs()
        worst_hs = max(worst_hs, float(diff.max()))
        if float((diff - atol - rtol * h.abs()).max()) > 0:
            raise RuntimeError(f"{XLSTM} narrow f32: the sLSTM cell output "
                               f"or a cache differs card vs CPU beyond rtol "
                               f"1e-4 / atol 1e-5 ({float(diff.max()):.3e})")
    top = float(sides["cpu"][0][0].abs().max())
    for i, (c, h) in enumerate(zip(sides["cuda"][0], sides["cpu"][0])):
        worst_lg = max(worst_lg, float((c - h).abs().max()))
        if worst_lg > 0.05 * top:
            raise RuntimeError(f"{XLSTM} narrow f32: logits {i} differ card "
                               f"vs CPU by {worst_lg:.3e}, beyond 5 % of "
                               f"max|logit| {top:.3f}")
    calls = len(sides["cuda"][1])
    print(f"  {XLSTM} narrow f32 ({cfg.n_layers} layers, chunk "
          f"{cfg.mlstm_chunk}, prompt {prompt}, {steps} teacher-forced "
          f"decode steps): sLSTM cell output before the bf16 cast "
          f"({calls} calls) and the caches card vs CPU "
          f"max|diff| {worst_hs:.3e} (rtol 1e-4 / atol 1e-5); logits "
          f"max|diff| {worst_lg:.3e} = {worst_lg / top:.5f} of max|logit| "
          f"(5 % rule); no K5 or K6 launched", flush=True)
    # the card's decode from an empty cache against its own prefill
    p = tree_map(lambda x: x.cuda(), params)
    toks = tokens.cuda()
    n = prompt + steps
    with torch.inference_mode():
        full, _ = tfm.prefill(p, cfg, toks)
        cache = tfm.init_cache(cfg, batch, n, device="cuda")
        worst = 0.0
        for t in range(n):
            lg, cache = tfm.decode_step(p, cache, cfg, toks[:, t:t + 1], t)
            worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    if worst > 6e-3:
        raise RuntimeError(f"{XLSTM} narrow on the card: decode differs "
                           f"from prefill by {worst:.3e} (> 6e-3)")
    print(f"  {XLSTM} narrow on the card: decode of {n} positions against "
          f"prefill, max|diff| {worst:.3e} (6e-3)", flush=True)
    return worst_hs, worst_lg


def xlstm_round_card_vs_cpu(torch) -> None:
    """Phase 10's xLSTM rows: one narrow fedhen round of reduced
    xlstm-1.3b on the card against the CPU (phase 10's settings).  With
    ``_slstm_out``'s bf16 cast in place on both sides, where a one-ulp f32
    difference can flip a bf16 rounding of the cell output and the sLSTM
    FFN trains in bf16: losses and eval losses at rtol 1e-4 and each
    parameter's update (after - before) within bf16 rounding (2^-7 of its
    leaf's largest).  With the FFN kept in f32 (``_f32_slstm_out``) on
    both sides: server params at rtol 1e-4 / atol 1e-5, losses within
    1e-5 (``_hold``)."""
    from repro_torch import configs
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import synthetic_lm
    cfg = configs.get_reduced(XLSTM)
    shards = [{"tokens": s["tokens"]} for s in iid_split(
        synthetic_lm(32, 16, cfg.vocab_size, seed=0), 4, seed=1)]
    test = {"tokens": synthetic_lm(8, 16, cfg.vocab_size,
                                   seed=999)["tokens"]}
    fed = FedConfig(n_devices=4, n_simple=2, participation=1.0,
                    local_epochs=1, batch_size=4, cohort_chunk=1,
                    algorithm="fedhen")

    def build(dev):
        return FederatedTrainer(LMAdapter(cfg), fed, shards, device=dev,
                                generator=torch.Generator().manual_seed(0))
    start = _flat_server(build("cpu"))
    sides = _narrow_pair_runs(torch, build, 1, test)
    worst = 0.0
    for a, b, x0 in zip(sides["card"][1], sides["cpu"][1], start):
        du, dv = a.cpu() - x0, b.cpu() - x0
        worst = max(worst, float((du - dv).abs().max()))
        limit = 2.0 ** -7 * float(dv.abs().max())
        if float(((du - dv).abs() - limit - 2.0 ** -7 * dv.abs()).max()) > 0:
            raise RuntimeError(f"{XLSTM} narrow round: the updates differ "
                               f"card vs CPU beyond bf16 rounding")
    mc, mp = sides["card"][0][-1], sides["cpu"][0][-1]
    for key in ("loss_simple", "loss_complex"):
        if abs(mc[key] - mp[key]) > 1e-4 * abs(mp[key]):
            raise RuntimeError(f"{XLSTM} narrow round: {key} {mc[key]} "
                               f"against {mp[key]}")
    print(f"  narrow LM round {XLSTM} reduced fedhen, card vs CPU (bf16 "
          f"cast in place): updates within bf16 rounding (max abs "
          f"{worst:.3e}), losses within rtol 1e-4; card "
          f"{json.dumps(mc)}", flush=True)
    with _f32_slstm_out():
        sides = _narrow_pair_runs(torch, build, 1, test)
    worst = _hold(f"LM {XLSTM} fedhen (f32 FFN)", sides["card"],
                  sides["cpu"])
    print(f"  narrow LM round {XLSTM} reduced fedhen, sLSTM FFN in f32, card "
          f"vs CPU: server params within rtol 1e-4 / atol 1e-5 (max abs "
          f"{worst:.3e})", flush=True)


@contextlib.contextmanager
def _slstm_seconds(torch):
    """Seconds spent in ``xlstm.apply_slstm`` calls (training and prefill
    forward), on a host clock synchronised with the card at each call's
    ends: a list of per-call seconds."""
    from repro_torch.models import xlstm
    seen, fn = [], xlstm.apply_slstm

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        seen.append(time.perf_counter() - t)
        return out
    xlstm.apply_slstm = timed
    try:
        yield seen
    finally:
        xlstm.apply_slstm = fn


def xlstm_serve(torch) -> dict:
    """Phase 16(a): xlstm-1.3b whole in bf16 through ``serve.generate``
    (``serving``: batch 1, prompt 4096, 8 new tokens, greedy; its prefill
    launches no K5 and no K6), then the steady prefill: the same prompt
    prefilled again, timed, and once more with each sLSTM layer timed on a
    synchronised clock for the sLSTM step loop's share."""
    out = serving(torch, XLSTM_SERVE_RUNS, steady=True)
    row = out["runs"][0]
    print(f"  {XLSTM} served: prefill first {row['prefill_s']:.4f} s, "
          f"steady {row['steady_prefill_s']:.4f} s (sLSTM layers "
          f"{row['steady_slstm_s']:.4f} s = "
          f"{row['steady_slstm_share']:.3f} of a synchronised prefill of "
          f"{row['steady_synced_prefill_s']:.4f} s); decode "
          f"{row['decode_ms_per_step']:.2f} ms/step; "
          f"{row['new_tokens_per_s']:.2f} new tokens/s; peak "
          f"{row['peak_gib']:.2f} GiB", flush=True)
    return out


def _steady_prefill(torch, params, cfg, prompts, counts,
                    per_prefill: tuple) -> dict:
    """Two more prefills of ``prompts``: one timed (the steady prefill),
    one with the sLSTM layers timed; each must launch what the first did
    (``per_prefill``)."""
    from repro_torch.models import transformer as tfm
    before = counts()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = tfm.prefill(params, cfg, prompts)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t
        del logits
        with _slstm_seconds(torch) as seen:
            t = time.perf_counter()
            logits, _ = tfm.prefill(params, cfg, prompts)
            torch.cuda.synchronize()
            synced = time.perf_counter() - t
        del logits
    launched = tuple(a - b for a, b in zip(counts(), before))
    if launched != tuple(2 * k for k in per_prefill):
        raise RuntimeError(f"{cfg.name}: two steady prefills launched "
                           f"{launched}, the first {per_prefill}")
    return {"steady_prefill_s": steady, "steady_synced_prefill_s": synced,
            "steady_slstm_s": sum(seen), "steady_slstm_calls": len(seen),
            "steady_slstm_share": sum(seen) / synced}


def _slstm_layer_cost(torch, cfg, batch: int, seq: int) -> dict:
    """One sLSTM layer of ``cfg`` (its own weights from seed 3) at the
    round's shape: forward with autograd, then backward, each timed on a
    synchronised clock (the second of two calls)."""
    from repro_torch.models import xlstm
    p = xlstm.init_slstm(torch.Generator("cuda").manual_seed(3), cfg)
    for x in p.values():
        if isinstance(x, torch.Tensor):
            x.requires_grad_(True)
    p["norm"]["scale"].requires_grad_(True)
    h = torch.randn((batch, seq, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4)
                    ).to(cfg.torch_compute_dtype()).requires_grad_(True)
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = xlstm.apply_slstm(p, h, cfg)
        torch.cuda.synchronize()
        fwd = time.perf_counter() - t
        t = time.perf_counter()
        y.float().square().sum().backward()
        torch.cuda.synchronize()
        bwd = time.perf_counter() - t
    del p, h, y
    torch.cuda.empty_cache()
    return {"forward_s": fwd, "backward_s": bwd}


def full_width_rounds(torch, ops, arch: str, seq: int) -> tuple:
    """Phases 16(b) and 17(c): one fedhen flat round of ``arch`` at full
    width on the LM cell's settings (``lm_cell``: 8 clients at 0.25, 4
    sequences a client at batch 2, ``synthetic_lm`` over the first 4,096
    ids at most and over the arch's codebooks, the f32 wire) on sequences
    of ``seq`` model inputs; then a second round under ``torch.profiler``
    (device activity only) for the device's busy time and idle share.
    Per round: wall, losses, eval, bytes against the closed form, peak;
    K1's launches (2 a round, one a fold) counted from 0.  Returns (the
    rounds' record, the layout, the flat mask, the config), the trainer
    freed."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import lm_cell as cell
    t0 = time.perf_counter()
    shards = cell.shards("cuda", seq=seq, arch=arch)
    test = cell.test_batch(seq=seq, arch=arch)
    nc = 1 if test["tokens"].ndim == 2 else test["tokens"].shape[2]
    print(f"  data: {len(shards) * cell.PER_CLIENT} sequences of {seq} "
          f"inputs x {nc} codebook(s) over {len(shards)} clients in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trainer = cell.trainer(shards, "fedhen", arch=arch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    layout = trainer.layout
    n_m = int(trainer.flat_mask.sum())
    want_bytes = 8 * (n_m + layout.n_params)
    cfg = trainer.adapter.cfg
    print(f"  {arch} fedhen: n_flat {layout.n_flat:,} "
          f"({layout.n_flat / 2**31:.3f} x 2**31), {layout.n_params:,} "
          f"params in {layout.n_leaves} leaves, |M| {n_m:,}, exit after "
          f"layer {cfg.resolved_exit_layer}; trainer built in {init_s:.1f} "
          f"s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB held",
          flush=True)
    out = {"rounds": [], "n_flat": layout.n_flat,
           "n_params": layout.n_params, "n_m": n_m, "seq": seq,
           "init_s": init_s}
    _zero_counts(ops)
    for traced in (False, True):
        billed = trainer.total_bytes
        torch.cuda.synchronize()
        busy = None
        if traced:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                m = trainer.run_round()
                torch.cuda.synchronize()
                round_s = time.perf_counter() - t
            # the raw device records: building the profiler's op tree
            # (prof.events()) over the sLSTM loops' ~10^6 launches takes
            # minutes
            busy = sum(e.duration_ns()
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA
                       ) / 1e9
            del prof
        else:
            t = time.perf_counter()
            m = trainer.run_round()
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t
        t = time.perf_counter()
        ev = trainer.evaluate(test)
        torch.cuda.synchronize()
        row = {"round": trainer.server.round, "traced": traced,
               "round_s": round_s, "eval_s": time.perf_counter() - t,
               "bytes": trainer.total_bytes - billed,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "train": m, "eval": ev}
        if busy is not None:
            row.update(device_busy_s=busy, idle_share=1.0 - busy / round_s)
        print("  " + json.dumps(row), flush=True)
        values = [m["loss_simple"], m["loss_complex"]] + [
            ev[k] for k in ("loss_simple", "loss_complex")]
        if not all(math.isfinite(v) for v in values) or m["n_valid"] != 2:
            raise RuntimeError(f"{arch} round: {m} {ev}")
        if row["bytes"] != want_bytes:
            raise RuntimeError(f"{arch} round: {row['bytes']} bytes billed, "
                               f"expected {want_bytes}")
        out["rounds"].append(row)
    c = _counts(ops)
    out["launches"] = c[0]
    if c != (4, 0, 0, 0):
        raise RuntimeError(f"{arch} rounds: launches K1/K2/K3/K4 {c}, "
                           f"expected K1 twice a round")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {arch} rounds: K1 launches {c[0]} over 2 rounds (one a "
          f"fold); peak {out['peak_gib']:.2f} GiB", flush=True)
    mask = trainer.flat_mask
    del trainer, shards
    gc.collect()
    torch.cuda.empty_cache()
    return out, layout, mask, cfg


def xlstm_round(torch, ops, ref, bw: float) -> dict:
    """Phase 16(b): xlstm-1.3b's rounds (``full_width_rounds``) on
    sequences of 1024 model inputs (the published mlstm_chunk).  Then one
    sLSTM layer's forward and backward at the round's shape, timed, for
    the step loop's share of the round; and K1 at the cell's fold (N =
    n_flat, the real mask) bitwise against its plain version and timed
    beside its byte bound (``check_folds_lm``)."""
    from repro_torch.launch import lm_cell as cell
    seq = cell.XLSTM_SEQ
    out, layout, mask, cfg = full_width_rounds(torch, ops, XLSTM, seq)
    cost = _slstm_layer_cost(torch, cfg, cell.FED["batch_size"], seq)
    # a round: 2 SGD steps of the complex client (every sLSTM layer) and
    # of the simple one (the sLSTM layers before the exit)
    n_slstm = sum(1 for i in range(cfg.n_layers)
                  if cfg.layer_spec(i).mixer == "slstm")
    n_simple = sum(1 for i in range(cfg.resolved_exit_layer)
                   if cfg.layer_spec(i).mixer == "slstm")
    calls = 2 * (n_slstm + n_simple)
    est = calls * (cost["forward_s"] + cost["backward_s"])
    out["slstm"] = dict(cost, calls_a_round=calls, round_s_estimate=est,
                        share_of_round=est / out["rounds"][0]["round_s"])
    print(f"  one sLSTM layer at (2, {seq}): forward {cost['forward_s']:.3f}"
          f" s, backward {cost['backward_s']:.3f} s; {calls} calls a round "
          f"(training only) = {est:.2f} s, "
          f"{out['slstm']['share_of_round']:.3f} of round 1's wall",
          flush=True)
    out.update(check_folds_lm(torch, ops, ref, bw, layout, mask,
                              keys=("k1",)))
    return out


def xlstm_phase(torch, ops, ref, bw: float) -> dict:
    """Phase 16: xLSTM at full width (bf16, random weights)."""
    t = time.perf_counter()
    out = {"serve": xlstm_serve(torch)}
    torch.cuda.empty_cache()
    out["round"] = xlstm_round(torch, ops, ref, bw)
    print(f"  phase 16 in {time.perf_counter() - t:.1f} s", flush=True)
    return out


# -- phase 17: llava-next-34b and musicgen-large -----------------------------

LLAVA, MUSICGEN = "llava-next-34b", "musicgen-large"
# (arch, batch, prompt, new tokens, launches of one prefill: K5 on the
#  tensor cores, K5 on the CUDA cores, K6): llava-next-34b whole (63.2 GiB
#  of bf16 weights), text-only, as serve.main serves it; musicgen-large at
#  batch 4 on 1536 frames of its 4 codebooks (30.72 s of EnCodec frames at
#  50 Hz: MusicGen's 30 s rounded up to the prefill's 512-position chunks,
#  which a prompt longer than one chunk must fill, as in the reference)
LLAVA_SERVE_RUNS = ((LLAVA, 1, 4096, 8, (60, 0, 0)),)
MUSICGEN_SERVE_RUNS = ((MUSICGEN, 4, 1536, 32, (48, 0, 0)),)
LLAVA_TEXT = 1216            # text tokens after the 2880 patch rows: 4096
LLAVA_STEPS = 7              # decode steps after the frontend's prefill
MUSICGEN_SEQ = 512           # frames a training sequence (x 4 codebooks)


def llava_frontend(torch) -> dict:
    """Phase 17(a)'s second run: llava-next-34b whole (weights from seed
    0, as phase 17(a)'s first run draws them), one prefill of the config's
    2880 ``synthetic_frontend_embeds`` patch rows and :data:`LLAVA_TEXT`
    text tokens (4096 positions, a cache of 4104), timed twice (first,
    steady), each launching the tensor-core K5 once a layer and nothing
    else; then :data:`LLAVA_STEPS` greedy decode steps from position 4096,
    launching no kernel.  Logits finite and of their shapes."""
    from repro_torch import configs
    from repro_torch.data.synthetic import synthetic_frontend_embeds
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rglru_scan.ops import lru_scan, lru_scan_gated
    from repro_torch.models import transformer as tfm

    def counts():
        return (flash_attention.launches_tc, flash_attention.launches,
                lru_scan.launches + lru_scan_gated.launches)
    cfg = configs.get_config(LLAVA)
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    f = cfg.frontend
    flash_attention.launches_tc = flash_attention.launches = 0
    lru_scan.launches = lru_scan_gated.launches = 0
    extra = torch.from_numpy(synthetic_frontend_embeds(
        1, f.n_tokens, f.d_in, seed=2)).cuda()
    text = torch.randint(0, cfg.vocab_size, (1, LLAVA_TEXT), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
    n = f.n_tokens + LLAVA_TEXT
    out = {"frontend_rows": f.n_tokens, "frontend_text": LLAVA_TEXT,
           "frontend_cache_len": n + LLAVA_STEPS + 1}
    with torch.inference_mode():
        for label in ("first", "steady"):
            before = counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = tfm.prefill(params, cfg, text,
                                        extra_embeds=extra,
                                        cache_len=n + LLAVA_STEPS + 1)
            torch.cuda.synchronize()
            out[f"frontend_prefill_{label}_s"] = time.perf_counter() - t
            launched = tuple(a - b for a, b in zip(counts(), before))
            if tuple(logits.shape) != (1, n, cfg.vocab_size) or not bool(
                    torch.isfinite(logits).all()):
                raise RuntimeError(f"{LLAVA} frontend prefill: logits "
                                   f"{tuple(logits.shape)}, or not finite")
            if launched != (cfg.n_layers, 0, 0):
                raise RuntimeError(f"{LLAVA} frontend prefill: launches "
                                   f"{launched}, expected "
                                   f"({cfg.n_layers}, 0, 0)")
            tok = logits[:, -1].argmax(-1)[:, None]
            del logits
            if label == "first":
                del cache
        out["frontend_prefill_launches"] = launched
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(LLAVA_STEPS):
            logits, cache = tfm.decode_step(params, cache, cfg, tok, n + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        out["frontend_decode_ms_per_step"] = (
            (time.perf_counter() - t) / LLAVA_STEPS * 1e3)
        if counts() != before or not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{LLAVA} decode after the frontend: "
                               f"launches {counts()} against {before}, or "
                               f"logits not finite")
        del cache, logits, params
    out["frontend_launches"] = counts()
    out["frontend_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print("  " + json.dumps(out), flush=True)
    return out


def _served(arch: str, row: dict) -> None:
    print(f"  {arch} served (batch {row['batch']}, prompt {row['prompt']}, "
          f"{row['gen']} new): prefill first {row['prefill_s']:.4f} s, "
          f"steady {row['steady_prefill_s']:.4f} s; decode "
          f"{row['decode_ms_per_step']:.2f} ms/step; peak "
          f"{row['peak_gib']:.2f} GiB; K5 launches (tensor cores, CUDA "
          f"cores, K6) {tuple(row['launches_prefill'])} a prefill; exit "
          f"agreement {row['exit_agreement']:.4f}", flush=True)


def zoo_serve(torch) -> dict:
    """Phase 17(a) and (b): llava-next-34b whole through
    ``serve.generate`` (batch 1, prompt 4096, 8 new tokens, text-only) and
    its steady prefill, then the frontend's prefill and decode
    (``llava_frontend``); musicgen-large whole (batch 4, 1500 x 4
    prompt, 32 new frames), its steady prefill and the exit head's
    agreement over every codebook.  Each prefill launches the tensor-core
    K5 once a layer (60, 48) and decode none."""
    llava = serving(torch, LLAVA_SERVE_RUNS, steady=True)
    _served(LLAVA, llava["runs"][0])
    gc.collect()
    torch.cuda.empty_cache()
    row = llava["frontend"] = llava_frontend(torch)
    print(f"  {LLAVA} with {row['frontend_rows']} patch rows and "
          f"{row['frontend_text']} text tokens: prefill first "
          f"{row['frontend_prefill_first_s']:.4f} s, steady "
          f"{row['frontend_prefill_steady_s']:.4f} s, launches "
          f"{tuple(row['frontend_prefill_launches'])}; decode "
          f"{row['frontend_decode_ms_per_step']:.2f} ms/step from position "
          f"{row['frontend_rows'] + row['frontend_text']}; peak "
          f"{row['frontend_peak_gib']:.2f} GiB", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    musicgen = serving(torch, MUSICGEN_SERVE_RUNS, steady=True)
    _served(MUSICGEN, musicgen["runs"][0])
    torch.cuda.empty_cache()
    return {"llava": llava, "musicgen": musicgen}


def musicgen_round(torch, ops, ref, bw: float) -> dict:
    """Phase 17(c): musicgen-large's rounds (``full_width_rounds``) on
    sequences of :data:`MUSICGEN_SEQ` frames of its 4 codebooks; then K1
    at the cell's fold (N = n_flat, above 2**31, the real mask) bitwise
    against its plain version and timed beside its byte bound
    (``check_folds_lm``)."""
    out, layout, mask, _ = full_width_rounds(torch, ops, MUSICGEN,
                                             MUSICGEN_SEQ)
    out.update(check_folds_lm(torch, ops, ref, bw, layout, mask,
                              keys=("k1",)))
    return out


def zoo_serving_card_vs_cpu(torch) -> dict:
    """Phase 17(d), serving: reduced musicgen-large (2 codebooks, its 4
    conditioning rows) and reduced llava-next-34b (text-only, and with its
    8 patch rows), prefill of 64 tokens and 8 teacher-forced decode steps
    (final and exit heads) on the card against the CPU: f32 (K5 on the
    CUDA cores) at rtol 1e-4 / atol 1e-5, bf16 (K5 on the tensor cores)
    within 5 % of the CPU prefill's max|logit| (phase 8's rules); in f32
    also the card's prefill and decode against the card's prefill of the
    whole sequence, at rtol 1e-4 / atol 1e-5.  Returns each dtype's K5
    launches (tensor cores, CUDA cores) on the card."""
    from repro_torch import configs
    from repro_torch.data.synthetic import synthetic_frontend_embeds
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    rtol, atol = 1e-4, 1e-5
    prompt, steps, batch = 64, 8, 2
    launches = {}
    for dtype in ("float32", "bfloat16"):
        flash_attention.launches_tc = flash_attention.launches = 0
        tc = dtype == "bfloat16"
        for arch, patches in ((MUSICGEN, True), (LLAVA, False),
                              (LLAVA, True)):
            cfg = configs.get_reduced(arch).with_overrides(
                param_dtype=dtype, compute_dtype=dtype)
            params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
            nc = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
            tokens = torch.randint(0, cfg.vocab_size,
                                   (batch, prompt + steps) + nc,
                                   generator=torch.Generator().manual_seed(1))
            f = cfg.frontend
            extra = (torch.from_numpy(synthetic_frontend_embeds(
                batch, f.n_tokens, f.d_in, seed=2)) if patches else None)
            n = f.n_tokens if patches else 0
            sides = {}
            for dev in ("cuda", "cpu"):
                p = tree_map(lambda x: x.to(dev), params)
                toks = tokens.to(dev)
                ex = None if extra is None else extra.to(dev)
                before = (flash_attention.launches_tc,
                          flash_attention.launches)
                with torch.inference_mode():
                    logits, cache = tfm.prefill(
                        p, cfg, toks[:, :prompt], extra_embeds=ex,
                        cache_len=n + prompt + steps)
                    outs = [logits]
                    for t in range(prompt, prompt + steps):
                        lg, cache, ex_lg = tfm.decode_step(
                            p, cache, cfg, toks[:, t:t + 1], n + t,
                            with_exit_head=True)
                        outs += [lg, ex_lg]
                    if dev == "cuda" and not tc:
                        full, _ = tfm.prefill(p, cfg, toks, extra_embeds=ex)
                sides[dev] = [o.cpu().float() for o in outs]
                if dev == "cuda":
                    got = (flash_attention.launches_tc - before[0],
                           flash_attention.launches - before[1])
                    if got != ((cfg.n_layers, 0) if tc
                               else (0, 2 * cfg.n_layers)):
                        raise RuntimeError(
                            f"{cfg.name} narrow {dtype}: K5 launches "
                            f"(tensor cores, CUDA cores) {got}, expected "
                            f"one of its dtype's a layer a prefill")
            worst = 0.0
            top = float(sides["cpu"][0].abs().max())
            rule = "rtol 1e-4 / atol 1e-5" if not tc else "5 % of max|logit|"
            for i, (c, h) in enumerate(zip(sides["cuda"], sides["cpu"])):
                diff = (c - h).abs()
                worst = max(worst, float(diff.max()))
                limit = 0.05 * top if tc else atol + rtol * h.abs()
                if float((diff - limit).max()) > 0:
                    raise RuntimeError(
                        f"{cfg.name} narrow {dtype}: card and CPU differ "
                        f"beyond {rule} in output {i} (prefill, then "
                        f"final/exit per step)")
            line = (f"  {cfg.name} narrow {dtype} ({cfg.n_layers} layers, "
                    f"{cfg.n_codebooks} codebook(s), {n} frontend rows, "
                    f"prompt {prompt}, K5 launches {got}): prefill logits "
                    f"and {steps} teacher-forced decode steps (final and "
                    f"exit heads), card vs CPU max|diff| {worst:.3e} = "
                    f"{worst / top:.5f} of max|logit| ({rule})")
            if not tc:
                # the card's prefill and decode against its prefill of the
                # whole sequence
                full = full.cpu().float()
                mine = [sides["cuda"][0]] + sides["cuda"][1::2]
                theirs = [full[:, :n + prompt]] + [
                    full[:, n + t:n + t + 1]
                    for t in range(prompt, prompt + steps)]
                dev_worst = 0.0
                for c, h in zip(mine, theirs):
                    diff = (c - h).abs()
                    dev_worst = max(dev_worst, float(diff.max()))
                    if float((diff - atol - rtol * h.abs()).max()) > 0:
                        raise RuntimeError(f"{cfg.name} narrow: decode "
                                           f"differs from prefill on the "
                                           f"card")
                line += (f"; on the card, decode against the prefill of "
                         f"all {n + prompt + steps} positions max|diff| "
                         f"{dev_worst:.3e}")
            print(line, flush=True)
        launches[dtype] = (flash_attention.launches_tc,
                           flash_attention.launches)
    return launches


def zoo_round_card_vs_cpu(torch) -> None:
    """Phase 17(d), training: one narrow fedhen round of reduced
    musicgen-large (``synthetic_lm`` over its 2 codebooks) and of reduced
    llava-next-34b (each sequence with its 8 ``synthetic_frontend_embeds``
    patch rows, which both trainers slice with the tokens) on the card
    against the CPU, phase 10's settings and rules (server params at rtol
    1e-4 / atol 1e-5, losses and eval metrics within 1e-5)."""
    from repro_torch import configs
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import (synthetic_frontend_embeds,
                                            synthetic_lm)
    fed = FedConfig(n_devices=4, n_simple=2, participation=1.0,
                    local_epochs=1, batch_size=4, cohort_chunk=1,
                    algorithm="fedhen")
    for arch, patches in ((MUSICGEN, False), (LLAVA, True)):
        cfg = configs.get_reduced(arch)
        f = cfg.frontend

        def data(n, seed):
            d = synthetic_lm(n, 16, cfg.vocab_size, seed=seed,
                             n_codebooks=cfg.n_codebooks)
            del d["labels"]
            if patches:
                d["extra_embeds"] = synthetic_frontend_embeds(
                    n, f.n_tokens, f.d_in, seed=seed)
            return d
        shards = iid_split(data(32, 0), 4, seed=1)
        test = data(8, 999)
        sides = _narrow_pair_runs(torch, lambda dev: FederatedTrainer(
            LMAdapter(cfg), fed, shards, device=dev,
            generator=torch.Generator().manual_seed(0)), 1, test)
        worst = _hold(f"LM {arch} fedhen", sides["card"], sides["cpu"])
        print(f"  narrow LM round {arch} reduced fedhen ({sorted(shards[0])}"
              f"), card vs CPU: server params within rtol 1e-4 / atol 1e-5 "
              f"(max abs {worst:.3e}); card "
              f"{json.dumps(sides['card'][0][-1])}", flush=True)


def zoo_phase(torch, ops, ref, bw: float) -> dict:
    """Phase 17: llava-next-34b and musicgen-large at full width (bf16,
    random weights), then their narrow card-vs-CPU checks."""
    t = time.perf_counter()
    out = {"serve": zoo_serve(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    out["round"] = musicgen_round(torch, ops, ref, bw)
    out["narrow"] = zoo_serving_card_vs_cpu(torch)
    zoo_round_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    print(f"  phase 17 in {time.perf_counter() - t:.1f} s", flush=True)
    return out


# -- phase 18: the launch-side step functions ---------------------------------

STEP_ARCH, GEMMA3 = "gemma2-2b", "gemma3-4b"
# the full-width step round: K clients (the first half simple), batch B,
# local steps L, cohort_chunk 1 (one fold a client)
STEP_K, STEP_B, STEP_L = 4, 2, 2
STEP_SIMPLE = (True, True, False, False)
# tests/test_fedround.py's tiny config, for the narrow step cases
STEP_TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                 vocab_size=64, exit_layer=1, compute_dtype="float32")


def _step_tokens(torch):
    """(K, B, L, S+1) tokens from the LM cell's data (``synthetic_lm``
    over 4,096 ids): client k's 4 sequences of 513 tokens as its (B, L)
    block."""
    from repro_torch.launch import lm_cell as cell
    return torch.stack([s["tokens"].reshape(STEP_B, STEP_L, -1)
                        for s in cell.shards("cuda")[:STEP_K]])


def check_deq_lm(torch, ops, ref, bw: float, mask) -> dict:
    """K2 at the step round's int8 fold: Z = 1, N = n_flat > 2**31, the
    real mask, quant_block 128, as a complex client (weight 1 on both
    sides of M) and a simple one (1 inside, 0 outside), bitwise against
    its plain version in slices of ``LM_SLICE`` (whole scale groups),
    then timed beside the bytes its weights need."""
    n = mask.numel()
    g = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randint(-127, 128, (1, n), generator=g, device="cuda",
                      dtype=torch.int8)
    scales = torch.rand((1, n // QB), generator=g, device="cuda") * 0.01
    acc0 = torch.randn((n,), generator=g, device="cuda")
    ones = torch.ones((1,), device="cuda")
    n_m = count_true(mask)
    groups = mask.view(-1, QB)
    m_groups = int(groups.any(dim=1).sum())
    rest_groups = int((~groups).any(dim=1).sum())
    del groups

    def row_bytes(live_m, live_rest):
        if live_m and live_rest:
            return n + 4 * (n // QB)
        return live_m * (n_m + 4 * m_groups) + live_rest * (
            n - n_m + 4 * rest_groups)
    timing = []
    for population, w_rest, rows, n_groups in (
            ("complex", ones, n, n // QB),
            ("simple", ones * 0, n_m, m_groups)):
        acc = acc0.clone()
        ops.masked_agg_acc_deq_(acc, q, scales, mask, ones, w_rest,
                                quant_block=QB)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in range(0, n, LM_SLICE):
            e = min(a + LM_SLICE, n)
            want = ref.masked_agg_acc_deq_ref(
                acc0[a:e], q[:, a:e], scales[:, a // QB:e // QB], mask[a:e],
                ones, w_rest, quant_block=QB)
            if not torch.equal(acc[a:e], want):
                diff = float((acc[a:e] - want).abs().max())
                raise RuntimeError(f"masked_agg_acc_deq at N={n:,}, "
                                   f"{population}: slice [{a:,}, {e:,}) "
                                   f"differs from the plain version by "
                                   f"{diff:.3e}")
            del want
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        del acc
        print(f"  masked_agg_acc_deq {population} fold int8 Z=1 N={n:,} "
              f"(N / 2**31 = {n / 2**31:.3f}): bitwise equal to the plain "
              f"version", flush=True)
        row = _fold_row(
            torch, f"masked_agg_acc_deq {population} fold Z=1",
            lambda: ops.masked_agg_acc_deq_(acc0, q, scales, mask, ones,
                                            w_rest, quant_block=QB),
            plain_ms, fold_bytes(torch, mask, ones, w_rest, row_bytes),
            rows + 4 * n_groups + 9 * n, 3 * rows, bw, iters=10)
        row.update(fold=population, plain_ms=plain_ms,
                   plain_note="in pieces, with the bitwise check",
                   max_abs_err=0.0)
        timing.append(row)
    del q, scales, acc0
    torch.cuda.empty_cache()
    return {"N": n, "Z": 1, "timing": timing}


def step_round(torch, ops, ref, bw: float) -> dict:
    """Phase 18(a): ``launch.steps.make_fed_round_step`` on Gemma-2 2B at
    full width (bf16, weights drawn on the card from seed 0), one model
    ``expand``-ed to a cohort of 4 (2 simple, 2 complex), ``cohort_chunk``
    1, batch 2, 2 local steps, sequences of 512 tokens from the LM cell's
    data, the flat mask precomputed and passed in: once on the f32 wire
    (K1 4 times) and once on the int8 wire (K2 4 times), each with its
    synchronised wall, peak and loss.  The int8 round is held to the f32
    one by ``tests/test_fedround.py``'s rule (loss at rtol 1e-5, every
    leaf within ``max|f32 leaf| / 100``).  Then K2 at this fold's shape
    (N = n_flat > 2**31) and K1 at it (phase 9's shape and mask), each
    bitwise against its plain version and timed beside its byte bound
    (:func:`check_deq_lm`, :func:`check_folds_lm`)."""
    from repro_torch import configs
    from repro_torch.core import aggregate, comm, flatten, masking
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves, tree_map

    cfg = configs.get_config(STEP_ARCH)
    t = time.perf_counter()
    params = LMAdapter(cfg).init(torch.Generator("cuda").manual_seed(0),
                                 "cuda")
    data = _step_tokens(torch)
    is_simple = torch.tensor(STEP_SIMPLE, device="cuda")
    layout = flatten.layout_of(params, total_multiple=2048)
    flat_mask = flatten.pack_mask(
        layout, masking.transformer_subnet_mask(params, cfg), "cuda")
    torch.cuda.synchronize()
    print(f"  {STEP_ARCH}: {layout.n_params:,} params, n_flat "
          f"{layout.n_flat:,} ({layout.n_flat / 2**31:.3f} x 2**31), |M| "
          f"{int(flat_mask.sum()):,}; cohort of {STEP_K} (expand), tokens "
          f"{tuple(data.shape)}; set-up {time.perf_counter() - t:.1f} s",
          flush=True)
    cohort = tree_map(lambda x: x[None].expand((STEP_K,) + x.shape), params)
    out = {"n_flat": layout.n_flat, "runs": [], "results": {}}
    results = {}
    for wire, expected in (("float32", (STEP_K, 0, 0, 0)),
                           ("int8", (0, STEP_K, 0, 0))):
        step = steps.make_fed_round_step(
            cfg, local_steps=STEP_L, cohort_chunk=1,
            engine=aggregate.EngineSpec(wire=comm.WireSpec(wire, QB)))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        _zero_counts(ops)
        torch.cuda.synchronize()
        t = time.perf_counter()
        new_c, loss = step(cohort, data, is_simple, flat_mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = _counts(ops)
        row = {"wire": wire, "round_s": wall, "loss": float(loss),
               "held_gib": held,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launched}
        print("  " + json.dumps(row), flush=True)
        if launched != expected:
            raise RuntimeError(f"step round ({wire}): launches K1/K2/K3/K4 "
                               f"{launched}, expected {expected}")
        if not math.isfinite(row["loss"]) or not bool(
                masking.tree_isfinite(new_c)):
            raise RuntimeError(f"step round ({wire}): non-finite result")
        results[wire] = new_c, loss
        # kept on the host: phase 19(a) holds the sharded round to these
        out["results"][wire] = (tree_map(lambda x: x.cpu(), new_c),
                                loss.cpu())
        out["runs"].append(row)
        del new_c, loss
    (f_c, f_loss), (q_c, q_loss) = results["float32"], results["int8"]
    if abs(float(q_loss) - float(f_loss)) > 1e-5 * abs(float(f_loss)):
        raise RuntimeError(f"step round: int8 loss {float(q_loss)} against "
                           f"f32 {float(f_loss)} (rtol 1e-5)")
    worst = 0.0
    for q, f in zip(tree_leaves(q_c), tree_leaves(f_c)):
        amax = float(f.abs().max().float()) + 1e-12
        d = float((q.float() - f.float()).abs().max())
        worst = max(worst, d / amax)
        if d > amax / 100.0:
            raise RuntimeError(f"step round: an int8 leaf {tuple(q.shape)} "
                               f"is {d:.3e} from the f32 one, above "
                               f"max|f32 leaf| / 100 = {amax / 100:.3e}")
    out["int8_vs_f32"] = {"loss_rel": abs(float(q_loss) - float(f_loss))
                          / abs(float(f_loss)), "worst_leaf_ratio": worst}
    print(f"  int8 against f32: loss {float(q_loss):.6f} / "
          f"{float(f_loss):.6f}, worst leaf max|diff| / max|f32 leaf| "
          f"{worst:.3e} (rule: 1e-2)", flush=True)
    out["launches"] = tuple(a + b for a, b in zip(
        out["runs"][0]["launches"], out["runs"][1]["launches"]))
    del results, f_c, q_c, cohort, params, data
    gc.collect()
    torch.cuda.empty_cache()
    out["k2"] = check_deq_lm(torch, ops, ref, bw, flat_mask)
    out["k1"] = check_folds_lm(torch, ops, ref, bw, layout, flat_mask,
                               keys=("k1",))["k1"]
    del flat_mask
    torch.cuda.empty_cache()
    return out


def _tiny_step_cases(np):
    """The narrow cases of ``tests/test_torch_steps*.py``: (label, step
    kwargs, tokens, cohort tree on the CPU or None (the model expanded),
    extra round_step args, launches of K1, K2, K4 on the card)."""
    from repro_torch.core import aggregate, comm
    rng = np.random.default_rng(1)
    data = rng.integers(0, 64, size=(4, 2, 2, 17)).astype(np.int32)
    clamp = np.random.default_rng(5).integers(
        0, 64, size=(4, 1, 3, 17)).astype(np.int32)
    f32, chunk2 = dict(local_steps=2), dict(local_steps=2, cohort_chunk=2)
    return (
        ("flat f32 chunk 1", dict(f32, cohort_chunk=1), data, (), (4, 0, 0)),
        ("flat f32 chunk 2", chunk2, data, (), (2, 0, 0)),
        ("flat f32 chunk 4", dict(f32, cohort_chunk=4), data, (), (1, 0, 0)),
        ("int8 chunk 2", dict(chunk2, engine=aggregate.EngineSpec(
            wire=comm.WireSpec("int8", QB))), data, (), (0, 2, 0)),
        ("tree", dict(chunk2, engine=aggregate.EngineSpec(engine="tree")),
         data, (), (0, 0, 2)),
        ("decouple", dict(chunk2, engine=aggregate.EngineSpec(
            algorithm="decouple", block_n=512)), data, (), (4, 0, 0)),
        ("staleness [2, 0, 2, 0]", chunk2, data,
         (None, np.array([2, 0, 2, 0], np.int32)), (2, 0, 0)),
        ("pad slot", chunk2, data,
         (None, None, np.array([True, False, True, True])), (2, 0, 0)),
        ("NaN client", dict(chunk2, nan_client=2), data, (), (2, 0, 0)),
        ("B < local_steps", dict(local_steps=3, cohort_chunk=2), clamp, (),
         (2, 0, 0)))


def steps_card_vs_cpu(torch, ops) -> dict:
    """Phase 18(b): the narrow step cases (:func:`_tiny_step_cases`) on
    the card against the port's CPU result, params and loss at rtol 1e-4
    / atol 1e-5, the int8 case under ``repro_torch.parity``'s rules (at
    most 1e-3 of the elements outside the tolerance, each within it plus
    the uploads' int8 step); K1, K2 and K4 counted from 0 over the card's
    runs (the tree case's K4 is the tree engine's)."""
    import numpy as np
    from repro_torch import parity
    from repro_torch.configs.base import LayerSpec, ModelConfig
    from repro_torch.core import comm, flatten
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map

    cfg = ModelConfig(pattern=(LayerSpec("attn"),), **STEP_TINY)
    base = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    layout = flatten.build_layout(base, total_multiple=2048)
    simple = torch.tensor(STEP_SIMPLE)
    expected = [0, 0, 0]
    _zero_counts(ops)
    for label, kw, data, args, launches in _tiny_step_cases(np):
        kw = dict(kw)
        nan_client = kw.pop("nan_client", None)
        sides = {}
        for dev in ("cuda", "cpu"):
            if nan_client is None:
                params = tree_map(lambda x: x.to(dev), base)
                cohort = tree_map(lambda x: x[None].expand(
                    (data.shape[0],) + x.shape), params)
            else:
                cohort = tree_map(lambda x: x[None].repeat(
                    (data.shape[0],) + (1,) * x.dim()).to(dev), base)
                cohort["final_norm"]["scale"][nan_client] = float("nan")
            extra = [None if a is None else torch.as_tensor(a).to(dev)
                     for a in args]
            step = steps.make_fed_round_step(cfg, **kw)
            sides[dev] = step(cohort, torch.as_tensor(data).to(dev),
                              simple.to(dev), *extra)
        (c_card, l_card), (c_cpu, l_cpu) = sides["cuda"], sides["cpu"]
        l_card, l_cpu = float(l_card), float(l_cpu)
        if nan_client is not None:
            ok_loss = math.isnan(l_card) and math.isnan(l_cpu)
        else:
            ok_loss = abs(l_card - l_cpu) <= 1e-5 + 1e-4 * abs(l_cpu)
        if not ok_loss:
            raise RuntimeError(f"step {label}: loss {l_card} on the card, "
                               f"{l_cpu} on the CPU")
        a = flatten.pack(layout, tree_map(lambda x: x.cpu(), c_card))
        b = flatten.pack(layout, c_cpu)
        if label.startswith("int8"):
            spec = comm.WireSpec("int8", QB)
            bound = torch.maximum(parity.wire_step(
                spec, flatten.pack(layout, base)), parity.wire_step(spec, b))
            res = parity.lossy_compare(a, b, bound)
            if res["share"] > 1e-3 or res["worst"] > 1.0:
                raise RuntimeError(f"step {label}: card vs CPU {res}")
            worst = res["max_abs"]
        else:
            worst = float((a - b).abs().max())
            if bool(((a - b).abs() > 1e-5 + 1e-4 * b.abs()).any()):
                raise RuntimeError(f"step {label}: card vs CPU max abs "
                                   f"{worst:.3e} beyond rtol 1e-4 / atol "
                                   f"1e-5")
        if not all(bool(torch.isfinite(x).all())
                   for x in tree_leaves(c_card)):
            raise RuntimeError(f"step {label}: non-finite params")
        expected = [e + n for e, n in zip(expected, launches)]
        print(f"  narrow step {label}: card vs CPU max abs {worst:.3e}, "
              f"loss {l_card:.6f} / {l_cpu:.6f}", flush=True)
    c = _counts(ops)
    launched = (c[0], c[1], c[3])
    print(f"  narrow steps: launches K1/K2/K4 {launched}, expected "
          f"{tuple(expected)}", flush=True)
    if launched != tuple(expected) or c[2]:
        raise RuntimeError(f"narrow steps: launches K1/K2/K3/K4 {c}, "
                           f"expected K1/K2/K4 {tuple(expected)}")
    return {"launches": launched}


def engine_spec_vs_legacy(torch) -> None:
    """Phase 18(c): ``aggregate.make_engine`` on the card, an EngineSpec
    against the deprecated loose form of the same engine, bitwise: a
    numpy-seeded cohort of 6 (one NaN client at weight 0, f32 weights)
    folded in chunks of 2 on the flat engine (f32, bf16 and int8 wires)
    and the tree engine (f32, bf16 wire), for fedhen and decouple."""
    import warnings
    import numpy as np
    from repro_torch.core import aggregate, comm, flatten
    from repro_torch.tree import tree_leaves, tree_map

    rng = np.random.default_rng(0)
    z = 6
    cohort = {"a": rng.normal(size=(z, 4, 3)), "b": rng.normal(size=(z, 300)),
              "c": {"w": rng.normal(size=(z, 3, 130)),
                    "v": rng.normal(size=(z, 7))},
              "periods": rng.normal(size=(z, 2, 5, 3))}
    cohort = tree_map(lambda x: torch.tensor(x, dtype=torch.float32,
                                             device="cuda"), cohort)
    for leaf in tree_leaves(cohort):
        leaf[3] = float("nan")
    mask = {"a": True, "b": False, "c": {"w": True, "v": False},
            "periods": torch.tensor([True, False],
                                    device="cuda").reshape(2, 1, 1)}
    simple = torch.tensor([True, False, True, False, False, True],
                          device="cuda")
    valid = torch.tensor([1.0, 0.5, 1.0, 0.0, 0.25, 1.0], device="cuda")
    template = tree_map(lambda x: x[0], cohort)
    layout = flatten.layout_of(template, total_multiple=512)
    flat_mask = flatten.pack_mask(layout, mask, "cuda")

    def run(engine):
        init, fold, finalize = engine
        state = init(template)
        for lo in range(0, z, 2):
            state = fold(state, tree_map(lambda x: x[lo:lo + 2], cohort),
                         simple[lo:lo + 2], valid[lo:lo + 2])
        return tree_leaves([m for m in finalize(state, template=template)
                            if m is not None])

    for kind, wire in (("flat", None), ("flat", "bfloat16"),
                       ("flat", "int8"), ("tree", None),
                       ("tree", "bfloat16")):
        for algorithm in ("fedhen", "decouple"):
            kw = dict(algorithm=algorithm, mask=mask, layout=layout,
                      flat_mask=flat_mask, block_n=512,
                      wire=wire and comm.WireSpec(wire, QB))
            spec = run(aggregate.make_engine(aggregate.EngineSpec(
                engine=kind, **kw)))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                legacy = run(aggregate.make_engine(kind, **kw))
            if not all(torch.equal(a, b) for a, b in zip(spec, legacy)) \
                    or not all(bool(torch.isfinite(a).all()) for a in spec):
                raise RuntimeError(f"make_engine {kind} {wire} {algorithm}: "
                                   f"the spec and legacy paths differ")
    print("  make_engine on the card: EngineSpec = loose form bitwise on "
          "flat f32 / bf16 / int8 and tree f32 / bf16, fedhen and "
          "decouple", flush=True)


def gemma3_round(torch, ops, ref, bw: float) -> dict:
    """Phase 18(d): gemma3-4b trained at full width in the LM cell's
    settings (``full_width_rounds``: one fedhen round, then one traced),
    its peak printed; then K1 at its fold (N = n_flat, above 2**31, the
    real mask) bitwise against its plain version and timed beside its
    byte bound (``check_folds_lm``)."""
    from repro_torch.launch import lm_cell as cell
    out, layout, mask, _ = full_width_rounds(torch, ops, GEMMA3, cell.SEQ)
    out.update(check_folds_lm(torch, ops, ref, bw, layout, mask,
                              keys=("k1",)))
    del mask
    torch.cuda.empty_cache()
    return out


def quickstart_card(torch, ops) -> dict:
    """Phase 18(e): ``examples/quickstart_torch.py``'s three algorithms on
    the card (36 rounds each, evaluated every 2), its rounds-to-target
    table printed (a measurement, not a gate); K1 counted."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    _zero_counts(ops)
    t = time.perf_counter()
    results = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _counts(ops)
    print(f"  quickstart: 3 x {quickstart.ROUNDS} rounds in {wall:.1f} s; "
          f"launches K1/K2/K3/K4 {launches}", flush=True)
    if not launches[0] or any(launches[1:]):
        raise RuntimeError(f"quickstart: launches K1/K2/K3/K4 {launches}")
    return {"results": results, "wall_s": wall, "launches": launches[0]}


def steps_phase(torch, ops, ref, bw: float) -> dict:
    """Phase 18: the launch-side step functions, gemma3-4b's training at
    full width and the quickstart example on the card."""
    t = time.perf_counter()
    out = {"round": step_round(torch, ops, ref, bw)}
    out["narrow"] = steps_card_vs_cpu(torch, ops)
    engine_spec_vs_legacy(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["gemma3"] = gemma3_round(torch, ops, ref, bw)
    out["quickstart"] = quickstart_card(torch, ops)
    print(f"  phase 18 in {time.perf_counter() - t:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 19. the cohort-sharded round, chunk2d attention, the roofline ledger
# ---------------------------------------------------------------------------

# one default group for both devices: NCCL for the card's mesh, gloo for
# the CPU's (phase 19(b) holds the one against the other)
SHARD_BACKEND = "cuda:nccl,cpu:gloo"
# phase 6's llava-next-34b shape and gemma2-2b's windowed layer, bf16
CHUNK2D_CASES = (("llava-next-34b", 1, 4096, 56, 8, 128, 0, 0.0),
                 ("gemma2-2b window", 1, 8192, 8, 4, 256, 4096, 50.0))
CHUNK2D_Q, CHUNK2D_K = 512, 2048


def _timed_allreduce(torch, aggregate, calls: list):
    """``aggregate.allreduce_state`` wrapped to record each call's bytes
    and CUDA events around it (the round step calls it through the
    module)."""
    inner = aggregate.allreduce_state

    def timed(state, group, *extra):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        inner(state, group, *extra)
        end.record()
        calls.append((aggregate.allreduce_bytes(state, *extra), start, end))
        return state
    return inner, timed


def _unsharded_rounds(torch, cfg, cohort, data, is_simple, flat_mask):
    """Phase 18(a)'s two rounds again (for phase 19 run alone): the
    unsharded step on the f32 and int8 wires, results on the host."""
    from repro_torch.core import aggregate, comm
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map
    out = {}
    for wire in ("float32", "int8"):
        step = steps.make_fed_round_step(
            cfg, local_steps=STEP_L, cohort_chunk=1,
            engine=aggregate.EngineSpec(wire=comm.WireSpec(wire, QB)))
        new_c, loss = step(cohort, data, is_simple, flat_mask)
        out[wire] = (tree_map(lambda x: x.cpu(), new_c), loss.cpu())
        del new_c, loss
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sharded_round(torch, ops, unsharded=None) -> dict:
    """Phase 19(a): ``make_fed_round_step(cfg, MeshPolicy(...))`` over a
    live (1, 1) ``DeviceMesh`` on the card (NCCL, world size 1) at phase
    18(a)'s settings (Gemma-2 2B at full width, K = 4 expanded, 2 simple,
    chunk 1, batch 2, 2 local steps, S 512), on the f32 wire (K1 4 times)
    and the int8 wire (K2 4 times): new model and loss bitwise phase
    18(a)'s unsharded round (``unsharded``; computed here when phase 19
    runs alone), one all-reduce a round of the engine state and the loss
    sum (4 n_flat + 12 bytes), its bytes and device time printed beside
    the wall and the peak."""
    from repro_torch import configs
    from repro_torch.core import aggregate, comm, flatten, masking
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.tree import tree_leaves, tree_map

    cfg = configs.get_config(STEP_ARCH)
    params = LMAdapter(cfg).init(torch.Generator("cuda").manual_seed(0),
                                 "cuda")
    data = _step_tokens(torch)
    is_simple = torch.tensor(STEP_SIMPLE, device="cuda")
    layout = flatten.layout_of(params, total_multiple=2048)
    flat_mask = flatten.pack_mask(
        layout, masking.transformer_subnet_mask(params, cfg), "cuda")
    cohort = tree_map(lambda x: x[None].expand((STEP_K,) + x.shape), params)
    if unsharded is None:
        unsharded = _unsharded_rounds(torch, cfg, cohort, data, is_simple,
                                      flat_mask)
    policy = sharding.MeshPolicy(make_device_mesh(1, 1, "cuda"), cfg)
    want_bytes = 4 * layout.n_flat + 3 * 4
    out = {"n_flat": layout.n_flat, "runs": []}
    calls = []
    inner, timed = _timed_allreduce(torch, aggregate, calls)
    aggregate.allreduce_state = timed
    for wire, expected in (("float32", (STEP_K, 0, 0, 0)),
                           ("int8", (0, STEP_K, 0, 0))):
        step = steps.make_fed_round_step(
            cfg, policy, local_steps=STEP_L, cohort_chunk=1,
            engine=aggregate.EngineSpec(wire=comm.WireSpec(wire, QB)))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls.clear()
        _zero_counts(ops)
        torch.cuda.synchronize()
        t = time.perf_counter()
        new_c, loss = step(cohort, data, is_simple, flat_mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = _counts(ops)
        want_c, want_loss = unsharded[wire]
        same = torch.equal(loss.cpu(), want_loss) and all(
            torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(new_c),
                                                    tree_leaves(want_c)))
        row = {"wire": wire, "round_s": wall, "loss": float(loss),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launched, "allreduce_calls": len(calls),
               "allreduce_bytes": [c[0] for c in calls],
               "allreduce_ms": [c[1].elapsed_time(c[2]) for c in calls],
               "bitwise_unsharded": same}
        print("  (a) sharded step round " + json.dumps(row), flush=True)
        if launched != expected or len(calls) != 1 or \
                calls[0][0] != want_bytes or not same:
            raise RuntimeError(
                f"sharded step round ({wire}): launches {launched} "
                f"(expected {expected}), all-reduces {len(calls)} of "
                f"{[c[0] for c in calls]} bytes (expected 1 of "
                f"{want_bytes}), bitwise the unsharded round: {same}")
        out["runs"].append(row)
        del new_c, loss
    aggregate.allreduce_state = inner
    out["launches"] = tuple(a + b for a, b in zip(
        out["runs"][0]["launches"], out["runs"][1]["launches"]))
    del cohort, params, data, flat_mask, unsharded
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_card_vs_cpu(torch, ops) -> dict:
    """Phase 19(b): the sharded step, narrow (``STEP_TINY``, K = 4, chunk
    2, 2 local steps), on the flat (f32) and tree engines, on the card's
    (1, 1) mesh (NCCL) against the CPU's (gloo), params and loss at rtol
    1e-4 / atol 1e-5; K1 and K4 counted on the card's runs."""
    import numpy as np
    from repro_torch.configs.base import LayerSpec, ModelConfig
    from repro_torch.core import aggregate, flatten
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map

    cfg = ModelConfig(pattern=(LayerSpec("attn"),), **STEP_TINY)
    base = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    layout = flatten.build_layout(base, total_multiple=2048)
    data = np.random.default_rng(1).integers(
        0, 64, size=(4, 2, 2, 17)).astype(np.int32)
    policies = {dev: sharding.MeshPolicy(make_device_mesh(1, 1, dev), cfg)
                for dev in ("cuda", "cpu")}
    _zero_counts(ops)
    for label, engine, launches in (
            ("flat", None, (2, 0, 0, 0)),
            ("tree", aggregate.EngineSpec(engine="tree"), (0, 0, 0, 2))):
        sides = {}
        for dev, policy in policies.items():
            params = tree_map(lambda x: x.to(dev), base)
            cohort = tree_map(lambda x: x[None].expand((4,) + x.shape),
                              params)
            step = steps.make_fed_round_step(cfg, policy, local_steps=2,
                                             cohort_chunk=2, engine=engine)
            before = _counts(ops)
            sides[dev] = step(cohort, torch.as_tensor(data).to(dev),
                              torch.tensor(STEP_SIMPLE, device=dev))
            if dev == "cuda":
                got = tuple(a - b for a, b in zip(_counts(ops), before))
                if got != launches:
                    raise RuntimeError(f"narrow sharded step {label}: "
                                       f"launches {got}, expected "
                                       f"{launches}")
        (c_card, l_card), (c_cpu, l_cpu) = sides["cuda"], sides["cpu"]
        a = flatten.pack(layout, tree_map(lambda x: x.cpu(), c_card))
        b = flatten.pack(layout, c_cpu)
        worst = float((a - b).abs().max())
        if bool(((a - b).abs() > 1e-5 + 1e-4 * b.abs()).any()) or \
                abs(float(l_card) - float(l_cpu)) > \
                1e-5 + 1e-4 * abs(float(l_cpu)):
            raise RuntimeError(f"narrow sharded step {label}: card vs CPU "
                               f"max abs {worst:.3e}, loss {float(l_card)} "
                               f"/ {float(l_cpu)}")
        print(f"  (b) narrow sharded step {label}: card (NCCL) vs CPU "
              f"(gloo) max abs {worst:.3e}, loss {float(l_card):.6f} / "
              f"{float(l_cpu):.6f}", flush=True)
    launched = _counts(ops)
    return {"launches": launched}


def chunk2d_card(torch) -> dict:
    """Phase 19(c): ``attention.chunk2d_attention`` on the card in bf16
    (q_chunk 512, k_chunk 2048) at llava-next-34b's shape and gemma2-2b's
    windowed layer, held to K5 (the tensor-core kernel) on the same inputs
    within 5 % of max|out|, each element within 2**-4 of its magnitude
    plus 2**-8 and each (row, head) within 2**-6 of its L2 norm, both
    timed (``time_ms``).  K5 is the yardstick
    here, and its launches are not counted to any path."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.attention import chunk2d_attention

    out = []
    for label, b, s, h, kh, dh, window, cap in CHUNK2D_CASES:
        g = torch.Generator("cuda").manual_seed(s + h)
        q = torch.randn((b, s, h, dh), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn((b, s, kh, dh), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn((b, s, kh, dh), generator=g, device="cuda",
                        dtype=torch.bfloat16)

        def c2d():
            return chunk2d_attention(q, k, v, window=window, softcap_val=cap,
                                     q_chunk=CHUNK2D_Q, k_chunk=CHUNK2D_K)

        def k5():
            return fa_ops.flash_attention(q, k, v, window=window,
                                          softcap=cap)
        got, want = c2d().float(), k5().float()
        amax = float(want.abs().max())
        diff = float((got - want).abs().max())
        # beside the serving rule, two that a masking error fails: each
        # element within 2**-4 of its magnitude (8 bf16 ulps) plus 2**-8,
        # and each (row, head) within 2**-6 of its norm (L2)
        elem = float(((got - want).abs() / (
            2 ** -4 * torch.maximum(got.abs(), want.abs()) + 2 ** -8)).max())
        rows = float(((got - want).norm(dim=-1)
                      / want.norm(dim=-1).clamp_min(1e-30)).max() / 2 ** -6)
        ms = time_ms(torch, c2d, iters=3, warmup=1)
        k5_ms = time_ms(torch, k5, iters=10, warmup=2)
        row = {"case": label, "shape": {"B": b, "S": s, "H": h, "Kh": kh,
                                        "Dh": dh, "window": window,
                                        "softcap": cap},
               "max_abs_diff": diff, "max_abs_out": amax,
               "elem_over_bound": elem, "row_over_bound": rows,
               "chunk2d_ms": ms, "k5_ms": k5_ms}
        print("  (c) chunk2d " + json.dumps(row), flush=True)
        if not diff <= 0.05 * amax:
            raise RuntimeError(f"chunk2d {label}: max|diff| {diff} beyond "
                               f"5 % of max|out| {amax}")
        if not (elem <= 1 and rows <= 1):
            raise RuntimeError(f"chunk2d {label}: element {elem} or row "
                               f"{rows} times its bound")
        out.append(row)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return {"cases": out}


def roofline_card(torch, ops) -> dict:
    """Phase 19(d): one round of the LM cell (phase 13's settings) with
    telemetry on, its ``roofline`` ledger printed: flops > 0; the walk's
    kernel counters hold the round's two K1 folds (Z = 1, N = n_flat)
    with the flops and bytes of that function, and hbm_bytes includes
    them; collective bytes; the new model bitwise that of the same round
    with telemetry off; the walk's added wall (round 0 on against off)."""
    from repro_torch.launch import lm_cell as cell
    from repro_torch.obs import telemetry as obslib
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    shards = cell.shards("cuda")
    off = cell.trainer(shards, "fedhen", device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    off.run_round()
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t
    want = [x.cpu() for x in tree_leaves(off.server.complex)]
    del off
    gc.collect()
    torch.cuda.empty_cache()
    mem = obslib.MemorySink()
    on = cell.trainer(shards, "fedhen", device="cuda",
                      telemetry=obslib.Telemetry([mem]))
    _zero_counts(ops)
    torch.cuda.synchronize()
    t = time.perf_counter()
    on.run_round()
    torch.cuda.synchronize()
    on_s = time.perf_counter() - t
    launched = _counts(ops)
    same = all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_leaves(on.server.complex), want))
    roof = mem.named("roofline")
    values = roof[0]["values"] if len(roof) == 1 else {}
    kernels = (on._dispatch.counters or {}).get("kernels")
    # K1 at Z = 1: acc read and written (f32), one row of the stream
    # dtype, the bool mask, two f32 weights; 2 N flops a call
    n = on.layout.n_flat
    elt = torch.empty((), dtype=on.engine_spec.stream_dtype).element_size()
    k1 = {"calls": 2, "flops": 2 * 2 * n, "bytes": 2 * ((9 + elt) * n + 8)}
    row = {"roofline": values, "kernels": kernels, "k1_expected": k1,
           "round_s_on": on_s, "round_s_off": off_s,
           "walk_added_s": on_s - off_s, "launches": launched,
           "bitwise_off": same}
    print("  (d) roofline ledger " + json.dumps(row), flush=True)
    if len(roof) != 1 or roof[0]["round"] != 0 or \
            list(values) != ["flops", "hbm_bytes", "collective_bytes"] or \
            not values["flops"] > 0 or kernels != {"masked_agg_acc": k1} or \
            values["hbm_bytes"] < k1["bytes"] or \
            values["flops"] < k1["flops"] or \
            launched != (2, 0, 0, 0) or not same:
        raise RuntimeError(f"roofline ledger on the card: {row}")
    del on, shards, want
    gc.collect()
    torch.cuda.empty_cache()
    return row


def sharded_phase(torch, ops, unsharded=None) -> dict:
    """Phase 19: the cohort-sharded step round over a live mesh (NCCL and
    gloo, world size 1), chunk2d attention on the card, the roofline
    ledger on the card.  The process group is destroyed at the end."""
    import torch.distributed as dist
    t = time.perf_counter()
    dist.init_process_group(SHARD_BACKEND, rank=0, world_size=1,
                            store=dist.HashStore(),
                            device_id=torch.device("cuda", 0))
    out = {"round": sharded_round(torch, ops, unsharded)}
    out["narrow"] = sharded_card_vs_cpu(torch, ops)
    dist.destroy_process_group()
    out["chunk2d"] = chunk2d_card(torch)
    out["roofline"] = roofline_card(torch, ops)
    print(f"  phase 19 in {time.perf_counter() - t:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 20. a live model axis: tensor parallelism, two ranks sharing the card
# ---------------------------------------------------------------------------

# two processes (torch.multiprocessing, one FileStore) share the one card
# over gloo in a (1, 2) mesh: NCCL refuses two ranks on one device
TP_RANKS = 2
TP_JOIN_S = 900
# (arch, batch, prompt, new tokens, launches of one sharded prefill on each
#  rank: K5 on the tensor cores, K5 on the CUDA cores, K6's gated entry):
#  each prefilled, then served gen - 1 steps on its sharded cache
#  (cache_len prompt + gen): minitron's heads, recurrentgemma's ring of
#  2048 over kv_seq and its RG-LRU state over 1280 of 2560 channels,
#  gemma2's dense global cache of 8200 slots and its ring of 4096, both
#  over kv_seq
TP_SERVE_RUNS = (("minitron-8b", 1, 4096, 8, (8, 0, 0)),
                 ("recurrentgemma-2b", 4, 4096, 8, (8, 0, 18)),
                 ("gemma2-2b", 1, 8192, 8, (26, 0, 0)))
# the depth phase 20 runs these configs at, their published widths kept:
# cut so that the smoke, cells (o)-(q) added, stays well inside its
# time limit (minitron-8b 32 -> 8 layers, qwen2-moe-a2.7b 24 -> 6,
# xlstm-1.3b 48 -> 8: one period of 7 mLSTM and 1 sLSTM, musicgen-large
# 48 -> 12); phases 14-17 serve them whole
TP_DEPTH = {"minitron-8b": 8, "qwen2-moe-a2.7b": 6, "xlstm-1.3b": 8,
            "musicgen-large": 12}


def _tp_config(arch: str, **over):
    """``arch``'s published config at phase 20's depth (``TP_DEPTH``)."""
    from repro_torch import configs
    depth = {"n_layers": TP_DEPTH[arch]} if arch in TP_DEPTH else {}
    return configs.get_config(arch).with_overrides(**{**depth, **over})
# the round against phase 18(a)'s: each leaf within 5 % of its max|value|
# (the bf16 rule of the prefills), the loss at rtol 1e-2.  The int8-vs-f32
# rule of phase 18(a) (1/100) holds two runs of the same training; here
# the training itself sums in another order (each rank's row-parallel
# partial sums rounded to bf16, then all-reduced), and on the CPU a norm
# scale (its values are one round's update) moved 1.17 % of its max.  The
# leaves over 1/100 are counted and printed beside the gate.
TP_LEAF_RULE = 0.05
TP_LEAF_INT8_RULE = 1e-2
TP_LOSS_RTOL = 1e-2
TP_LOGIT_RULE = 0.05    # logits within 5 % of max|logit| of the unsharded
# the shapes the sharded paths hand the kernels on each rank: minitron's
# 16 of 32 query heads and 4 of 8 kv heads, recurrentgemma's 1280 of 2560
# rnn channels (its attention is replicated: phase 6's shape)
TP_FLASH_CASES = (("minitron-8b, a rank's heads", 1, 4096, 16, 4, 128, 0,
                   0.0, "bfloat16", True),
                  ("qwen2-moe-a2.7b, a rank's heads", 1, 4096, 8, 8, 128, 0,
                   0.0, "bfloat16", True),
                  ("kimi-k2-1t-a32b, a rank's heads", 1, 4096, 32, 4, 112,
                   0, 0.0, "bfloat16", True),
                  ("musicgen-large, a rank's heads", 4, 1536, 16, 16, 64, 0,
                   0.0, "bfloat16", True))
# the part of phase 20 whose path hands K5 each of those shapes
TP_FLASH_PARTS = ("dense", "moe", "moe", "xlstm_codebooks")
TP_PARTS = ("dense", "moe", "xlstm_codebooks", "seq2d", "hybrid_audio",
            "moe_split", "ssm_split")
TP_GATED_CASES = ((4, 4096, 1280, "bfloat16", False, True),)
# phase 20(f), (g): the MoE configs over the (1, 2) mesh, each (part, arch,
#  batch, prompt, new tokens, launches of one sharded prefill on each rank:
#  K5 on the tensor cores, K5 on the CUDA cores, K6's gated entry; config
#  overrides): qwen2-moe-a2.7b whole (30 of 60 experts a rank, heads 8 /
#  16), kimi-k2-1t-a32b at published widths cut 61 -> 1 layer as in phase
#  15 (192 of 384 experts a rank, heads 32 / 64, kv 4 / 8; its 2-D experts'
#  data axis is 1).  The ranks build the full model in turn (kimi's layer is
#  36.5 GB: two at once would not fit), each serves it unsharded first and
#  records the router logits of every MoE call, then keeps its shards
TP_MOE_RUNS = (("f", "qwen2-moe-a2.7b", 1, 4096, 8, (6, 0, 0), {}),
               ("g", "kimi-k2-1t-a32b", 1, 4096, 8, (1, 0, 0),
                {"n_layers": 1}))
# phase 20(h): reduced qwen2-moe whose shards hold whole int8 groups on the
# (1, 2) mesh (heads at Dh 64, d_expert 256; tests/torch_mesh_cases.py's
# round config)
TP_MOE_NARROW = {"head_dim": 64, "d_expert": 256}
# phase 20(r): qwen2-moe-a2.7b (hf:Qwen/Qwen1.5-MoE-A2.7B) at published
#  widths and (f)'s depth (6 of 24 layers) under seq2d, weights replicated:
#  batch 1, prompt 4096, each rank prefilling its 2048 rows (each MoE
#  layer's routing groups split over the ranks: the whole sequence's
#  capacity, rank 1's queue places after rank 0's pairs), rank 1's
#  attention on K5's query-offset entry, then 7 serve steps with the exit
#  head; the ranks build in turn and replay the unsharded run's router
#  logits, each its rows
TP_MOE_SPLIT_RUNS = (("r", "qwen2-moe-a2.7b", 1, 4096, 8, (6, 0, 0),
                      {"attn_shard": "seq2d"}),)
# phase 20(s): reduced qwen2-moe-a2.7b and kimi-k2-1t-a32b (f32) under
#  seq2d, dp2d and seq2d_fsdp, card against CPU: each (arch, mode, round
#  engines, prompt positions, MoE overrides); qwen2-moe at capacity factor
#  1.0, where rank 1 of a seq2d split drops pairs a routing of its own rows
#  would keep (counted on the card's train step and printed); its f32, int8
#  and tree rounds under seq2d and dp2d, its seq2d_fsdp cohort refused
TP_MOE_SPLIT_ENGINES = ("f32", "int8", "tree")
TP_MOE_SPLIT_NARROW = tuple(
    (arch, mode, (TP_MOE_SPLIT_ENGINES if mode != "seq2d_fsdp" else ("f32",))
     if arch == "qwen2-moe-a2.7b" else (), 256,
     {"capacity_factor": 1.0} if arch == "qwen2-moe-a2.7b" else {})
    for arch in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
    for mode in ("seq2d", "dp2d", "seq2d_fsdp"))
# phase 20(u): xlstm-1.3b at published widths, depth TP_DEPTH (one period
#  of 7 mLSTM and 1 sLSTM), under seq2d over the (1, 2) mesh: batch 1,
#  prompt 4096, each rank prefilling its 2048 rows (two mLSTM chunks of
#  1024), the mLSTM's conv halo and (C, n, m) state and the sLSTM's
#  (c, n, h, m) state chained from rank 0 to rank 1; then 7 serve steps
#  with the exit head on the cache cache_specs splits
TP_SSM_RUNS = (("u", "xlstm-1.3b", "seq2d", 1, 4096, 8),)
# phase 20(v): reduced xlstm-1.3b (f32, mlstm_chunk 8: a rank's rows are
#  whole chunks) under seq2d, dp2d and seq2d_fsdp, card against CPU as
#  (p), its sLSTM output kept in f32 (_f32_slstm_out): the train step,
#  under seq2d and dp2d the f32, int8 and tree rounds, a prefill of 64
#  positions (32 rows a rank under seq2d) and 6 serve steps
TP_SSM_NARROW = tuple(("xlstm-1.3b", mode, ("f32", "int8", "tree")
                       if mode != "seq2d_fsdp" else (), 64)
                      for mode in ("seq2d", "dp2d", "seq2d_fsdp"))
# phase 20(t): decode's routing group and kimi-k2's 2-D experts over the
#  data axis, the two ranks as a (2, 1) mesh, card against CPU: reduced
#  qwen2-moe's prefill (batch 2, 64 positions) and 6 serve steps (its
#  batch over data, each rank routing its row with the offsets of the rank
#  before), reduced kimi-k2 with 2-D experts (expert_ffn over data,
#  gathered by all-reduces): its train step (batch 2, 16 tokens), prefill
#  and 6 serve steps
TP_GROUP_PROMPT = 64
# phase 20(i), (j): xlstm-1.3b and musicgen-large whole over the (1, 2)
#  mesh, each (part, arch, batch, prompt, new tokens, launches of one
#  sharded prefill on each rank: K5 on the tensor cores, K5 on the CUDA
#  cores, K6's gated entry; conditioning rows before the prompt): xlstm at
#  phase 16's serving shape (four mLSTM chunks of 1024; every mixer whole
#  on each rank, the cache's C, n and conv split), musicgen at phase 17's
#  1536 positions at batch 4 (prefill takes a multiple of its 512-position
#  chunks), its 64 conditioning rows then 1472 frames of its 4 codebooks
#  (16 of 32 heads, 4096 of 8192 ffn columns and 1024 of 2048 rows of
#  each codebook table a rank)
TP_ZOO_RUNS = (("i", "xlstm-1.3b", 1, 4096, 8, (0, 0, 0), 0),
               ("j", "musicgen-large", 4, 1472, 8, (12, 0, 0), 64))
# phase 20(k): reduced musicgen-large whose shards hold whole int8 groups
# on the (1, 2) mesh (tests/torch_mesh_cases.py's round config)
TP_MUSICGEN_NARROW = {"head_dim": 128, "d_ff": 512}


def _local_slice(torch, full, dt):
    """The part of the full tensor ``full`` that DTensor ``dt``'s local
    shard holds on this rank."""
    from repro_torch.launch import sharding
    mesh = dt.device_mesh
    for i, pl in enumerate(dt.placements):
        if pl.is_shard():
            lo, hi = sharding.shard_rows(full.shape[pl.dim],
                                         mesh.get_local_rank(i),
                                         mesh.size(i))
            full = full.narrow(pl.dim, lo, hi - lo)
    return full


def _tp_kernel_counts(ops, fa, scan) -> tuple:
    return _counts(ops) + (fa.launches_tc, fa.launches,
                           scan.lru_scan_gated.launches)


def _tp_zero(ops, fa, scan) -> None:
    _zero_counts(ops)
    fa.launches_tc = fa.launches = scan.lru_scan_gated.launches = 0
    fa.launches_tc_rows = fa.launches_rows = 0
    scan.lru_scan_gated.launches_carry = 0


def _xlstm_layers(cfg) -> int:
    mixers = [cfg.layer_spec(i).mixer for i in range(cfg.n_layers)]
    return mixers.count("mlstm") + mixers.count("slstm")


@contextlib.contextmanager
def _chain_clock(torch):
    """Time the xLSTM mixers of a token split's run on this rank: each
    mixer call on a rank's rows (``xlstm._mlstm_split`` /
    ``_slstm_split``: the halo, the chain's hops and the waits for the
    ranks before and after) and the rank's own scan in it
    (``mlstm_chunked`` / ``slstm_block``), the card synchronised around
    each.  Yields ``{kind: {"layer_ms", "own_scan_ms", "layers"}}``, the
    means over the run's calls, filled when the block ends."""
    from repro_torch.models import xlstm
    names = {"mlstm": ("_mlstm_split", "mlstm_chunked"),
             "slstm": ("_slstm_split", "slstm_block")}
    saved = {n: getattr(xlstm, n) for pair in names.values() for n in pair}
    times = {n: [] for n in saved}

    def timed(name):
        fn = saved[name]

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            return out
        return run
    out = {}
    for name in saved:
        setattr(xlstm, name, timed(name))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            setattr(xlstm, name, fn)
    for kind, (layer, scan) in names.items():
        if times[layer]:
            out[kind] = {
                "layer_ms": sum(times[layer]) / len(times[layer]) * 1e3,
                "own_scan_ms": sum(times[scan]) / len(times[layer]) * 1e3,
                "layers": len(times[layer])}


def _mixer_counts(cfg) -> tuple:
    """(attention layers, RG-LRU layers) of ``cfg``: K5's and K6's
    launches in one prefill."""
    mixers = [cfg.layer_spec(i).mixer for i in range(cfg.n_layers)]
    return (sum(m in ("attn", "local_attn") for m in mixers),
            mixers.count("rglru"))


def tp_round(torch, rank: int, work: str, mesh) -> dict:
    """Phase 20(a) on one rank: phase 18(a)'s round (Gemma-2 2B at full
    width, K = 4 expanded, 2 simple, chunk 1, batch 2, 2 local steps) under
    a MeshPolicy over the live (1, 2) mesh, on the f32 wire (K1 4 times on
    the rank's local n_flat) then int8 (K2 4 times); each rank's wall,
    peak, launches and collectives; the new model's local shards and the
    loss against phase 18(a)'s unsharded round (saved by the parent)."""
    from repro_torch import configs
    from repro_torch.core import aggregate, comm
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.roofline import torch_walk
    from repro_torch.tree import tree_leaves, tree_map

    cfg = configs.get_config(STEP_ARCH)
    policy = sharding.MeshPolicy(mesh, cfg)
    t = time.perf_counter()
    full = LMAdapter(cfg).init(torch.Generator("cuda").manual_seed(0),
                               "cuda")
    cohort = sharding.distribute_cohort(tree_map(
        lambda x: x[None].expand((STEP_K,) + x.shape), full), cfg, mesh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    data = _step_tokens(torch)
    is_simple = torch.tensor(STEP_SIMPLE, device="cuda")
    local_params = sum(x.to_local()[0].numel() for x in tree_leaves(cohort))
    out = {"setup_s": time.perf_counter() - t, "local_params": local_params,
           "runs": []}
    for wire, expected in (("float32", (STEP_K, 0, 0, 0)),
                           ("int8", (0, STEP_K, 0, 0))):
        step = steps.make_fed_round_step(
            cfg, policy, local_steps=STEP_L, cohort_chunk=1,
            engine=aggregate.EngineSpec(wire=comm.WireSpec(wire, QB)))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        counter = torch_walk.Collectives()
        _tp_zero(ops, fa, scan)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with counter:
            new_c, loss = step(cohort, data, is_simple)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = _counts(ops)
        if launched != expected:
            raise RuntimeError(f"20(a) rank {rank} ({wire}): launches "
                               f"K1/K2/K3/K4 {launched}, expected {expected}")
        want_c, want_loss = torch.load(os.path.join(work, f"{wire}.pt"),
                                       mmap=True)
        worst, over = 0.0, 0
        for got, want in zip(tree_leaves(new_c), tree_leaves(want_c)):
            local = got.to_local().float()
            ref_part = _local_slice(torch, want, got).to("cuda").float()
            amax = float(ref_part.abs().max()) + 1e-12
            d = float((local - ref_part).abs().max())
            worst = max(worst, d / amax)
            over += d > TP_LEAF_INT8_RULE * amax
            if not math.isfinite(d) or d > TP_LEAF_RULE * amax:
                raise RuntimeError(
                    f"20(a) rank {rank} ({wire}): a local leaf "
                    f"{tuple(local.shape)} of {tuple(got.shape)} is {d:.3e} "
                    f"from the unsharded round's, above max|leaf| x "
                    f"{TP_LEAF_RULE:g} = {TP_LEAF_RULE * amax:.3e}")
            del local, ref_part
        loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        if not loss_rel <= TP_LOSS_RTOL:
            raise RuntimeError(f"20(a) rank {rank} ({wire}): loss "
                               f"{float(loss)} against the unsharded "
                               f"{float(want_loss)} (rtol {TP_LOSS_RTOL})")
        row = {"wire": wire, "round_s": wall, "loss": float(loss),
               "unsharded_loss": float(want_loss), "loss_rel": loss_rel,
               "worst_leaf_ratio": worst,
               "leaves_over_1_100": over, "leaves": len(tree_leaves(new_c)),
               "held_gib": held,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launched, "collectives": counter.counts,
               "collective_bytes": counter.bytes}
        print(f"  (a) rank {rank} " + json.dumps(row), flush=True)
        out["runs"].append(row)
        del new_c, loss, want_c
    del cohort, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _greedy_decode(torch, step, params, cache, first, pos: int, n: int,
                   lo: int, hi: int, feed=None):
    """``n`` serve steps from token ``first`` (B, 1) at position ``pos``,
    each next token the greedy pick of the step's full logits, or
    ``feed[i]`` where a list of tokens is given: the tokens fed, each
    step's logits and exit logits on vocab rows ``[lo, hi)`` (a DTensor's
    local shard holds those rows), and the host wall of the loop,
    synchronised."""
    from repro_torch.models.common import is_dtensor
    tokens, logits_rows, exit_rows = [], [], []
    tok = first
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(n):
        tokens.append(tok)
        logits, cache, exit_logits = step(params, cache, {"tokens": tok},
                                          pos + i)
        if is_dtensor(logits):
            logits_rows.append(logits.to_local())
            exit_rows.append(exit_logits.to_local())
        else:
            logits_rows.append(logits[..., lo:hi].clone())
            exit_rows.append(exit_logits[..., lo:hi].clone())
        if i + 1 < n:
            tok = feed[i + 1] if feed is not None else \
                torch.argmax(logits[:, -1], dim=-1)[:, None]
        del logits, exit_logits
    torch.cuda.synchronize()
    return tokens, logits_rows, exit_rows, time.perf_counter() - t


def tp_serving(torch, rank: int, mesh) -> list:
    """Phase 20(b), (c) and (e) on one rank, each config of
    ``TP_SERVE_RUNS`` at full width: the unsharded prefill and ``gen - 1``
    greedy serve steps with the exit head, of the same weights on this
    rank (run first, its launches not counted); then the sharded prefill
    under the (1, 2) policy (``cache_len`` prompt + gen) and the sharded
    serve steps on its cache, fed the unsharded run's tokens (a bf16
    near-tie must not fork the comparison).  This rank's vocab shard of
    the prefill logits and of each step's logits and exit logits within
    5 % of max|logit| of the unsharded; the prefill's K5 / K6 launches as
    expected and none in decode; no all-gather in either.  Prints the
    decode ms a step, the collectives a step and the peak."""
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.roofline import torch_walk
    from repro_torch.tree import tree_leaves

    def kernels():
        return (fa.launches_tc, fa.launches, scan.lru_scan_gated.launches)

    def check(label, got, want, amax):
        d = float((got.float() - want.float()).abs().max())
        if tuple(got.shape) != tuple(want.shape) or \
                not d <= TP_LOGIT_RULE * amax:
            raise RuntimeError(f"20 {label} rank {rank}: {tuple(got.shape)} "
                               f"against the unsharded {tuple(want.shape)}, "
                               f"{d:.4f} apart, above {TP_LOGIT_RULE} x "
                               f"max|logit| {amax:.3f}")
        return d

    rows = []
    for part, (arch, batch, prompt, gen, expected) in zip(
            "bce", TP_SERVE_RUNS):
        cfg = _tp_config(arch)
        cache_len = prompt + gen
        full = tfm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                               generator=torch.Generator("cuda")
                               .manual_seed(1), device="cuda")
        lo, hi = sharding.shard_rows(cfg.vocab_size,
                                     mesh.get_local_rank("model"),
                                     mesh.size(1))
        want, cache = steps.make_prefill_step(cfg, cache_len=cache_len)(
            full, {"tokens": tokens})
        amax = float(want.abs().max().float())
        first = torch.argmax(want[:, -1], dim=-1)[:, None]
        # keep this rank's vocab shard of the unsharded logits only (the
        # sharded logits are placed ("batch", "seq", "vocab"): vocab over
        # model)
        want = want[..., lo:hi].clone()
        fed, want_steps, want_exit, unsharded_s = _greedy_decode(
            torch, steps.make_serve_step(cfg, with_exit_head=True), full,
            cache, first, prompt, gen - 1, lo, hi)
        amax_step = max(float(x.abs().max().float()) for x in want_steps)
        amax_exit = max(float(x.abs().max().float()) for x in want_exit)
        del cache
        gc.collect()
        torch.cuda.empty_cache()
        params = sharding.distribute_params(full, cfg, mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        policy = sharding.MeshPolicy(mesh, cfg)
        prefill = steps.make_prefill_step(cfg, policy, cache_len=cache_len)
        torch.cuda.reset_peak_memory_stats()
        counter = torch_walk.Collectives()
        _tp_zero(ops, fa, scan)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with counter:
            logits, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = kernels()
        if launched != expected:
            raise RuntimeError(f"20 {arch} rank {rank}: launches K5 tc / K5 "
                               f"f32 / K6 gated {launched}, expected "
                               f"{expected}")
        local = logits.to_local()
        # a batch row and 1024 positions at a time (f32 copies of the whole
        # shard would take 8 GB a rank)
        d = max(check(arch, local[i, j:j + 1024], want[i, j:j + 1024], amax)
                for i in range(batch) for j in range(0, prompt, 1024))
        row = {"arch": arch, "batch": batch, "prompt": prompt,
               "prefill_s": wall, "max_abs_diff": d, "max_abs_logit": amax,
               "logits_local": list(local.shape),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launched, "collectives": counter.counts,
               "collective_bytes": counter.bytes}
        del logits, local, want
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counter = torch_walk.Collectives()
        with counter:
            _, got_steps, got_exit, decode_s = _greedy_decode(
                torch, steps.make_serve_step(cfg, policy,
                                             with_exit_head=True),
                params, cache, fed[0], prompt, gen - 1, lo, hi, feed=fed)
        if kernels() != launched:
            raise RuntimeError(f"20 {arch} rank {rank}: K5 / K6 launches "
                               f"{launched} after prefill, {kernels()} "
                               f"after decode (expected none in decode)")
        for c in (row["collectives"], counter.counts):
            if set(c) - {"all-reduce"}:
                raise RuntimeError(f"20 {arch} rank {rank}: collectives "
                                   f"{c}: all-reduces only on the card")
        steps_n = gen - 1
        row.update({
            "gen": gen, "cache_len": cache_len, "decode_steps": steps_n,
            "decode_ms_per_step": decode_s / steps_n * 1e3,
            "unsharded_decode_ms_per_step": unsharded_s / steps_n * 1e3,
            "decode_max_abs_diff": max(check(
                f"{arch} step {i}", g, w, amax_step) for i, (g, w) in
                enumerate(zip(got_steps, want_steps))),
            "decode_max_abs_logit": amax_step,
            "exit_max_abs_diff": max(check(
                f"{arch} exit step {i}", g, w, amax_exit) for i, (g, w) in
                enumerate(zip(got_exit, want_exit))),
            "exit_max_abs_logit": amax_exit,
            "decode_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "decode_collectives_per_step": {
                k: v / steps_n for k, v in counter.counts.items()},
            "decode_collective_bytes_per_step": {
                k: v / steps_n for k, v in counter.bytes.items()},
            "cache_placements": sorted({str(x.placements) for x in
                                        tree_leaves(cache)})})
        print(f"  ({part}) rank {rank} " + json.dumps(row), flush=True)
        rows.append(row)
        del params, cache, tokens, got_steps, got_exit, want_steps, want_exit
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _moe_full_then_shards(torch, rank: int, world: int, mesh, cfg, tokens,
                          gen: int, lo: int, hi: int) -> dict:
    """Phase 20(f), (g)'s unsharded half on one rank, the ranks in turn
    (a barrier between turns): this rank builds the full model from seed
    0, serves the prompt unsharded (prefill, then ``gen - 1`` greedy
    serve steps with the exit head) recording every MoE call's router
    logits (``_routes``), keeps the logits' vocab rows ``[lo, hi)``, then
    replaces the full model by its shards (``distribute_params``, in
    place) before the next rank builds."""
    import torch.distributed as dist
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves
    out = {}
    prompt = tokens.shape[1]
    for turn in range(world):
        dist.barrier()
        if turn != rank:
            continue
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        full = tfm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t
        out["params"] = sum(x.numel() for x in tree_leaves(full))
        with _routes() as prefill_calls:
            want, cache = steps.make_prefill_step(
                cfg, cache_len=prompt + gen)(full, {"tokens": tokens})
        out["amax"] = float(want.abs().max().float())
        first = torch.argmax(want[:, -1], dim=-1)[:, None]
        out["want"] = want[..., lo:hi].clone()
        del want
        with _routes() as decode_calls:
            out["fed"], out["steps"], out["exit"], out["unsharded_s"] = \
                _greedy_decode(torch, steps.make_serve_step(
                    cfg, with_exit_head=True), full, cache, first, prompt,
                    gen - 1, lo, hi)
        out["calls"] = (prefill_calls, decode_calls)
        out["unsharded_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del cache
        gc.collect()
        torch.cuda.empty_cache()
        out["shards"] = sharding.distribute_params(full, cfg, mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        out["held_gib"] = torch.cuda.memory_allocated() / 2**30
    dist.barrier()
    return out


def _replayed(label: str, calls, want) -> list:
    """Check that every MoE call of a sharded run was replayed from the
    unsharded run's router logits (``_routes(replay)``) and routed as it
    did, slot for slot; return, call by call, the (token, choice) pairs
    whose expert the sharded run's own logits would have changed (printed,
    not gated)."""
    import torch
    if len(calls) != len(want):
        raise RuntimeError(f"{label}: {len(calls)} MoE calls sharded, "
                           f"{len(want)} unsharded")
    for i, (c, w) in enumerate(zip(calls, want)):
        if not torch.equal(c["replayed"]["slot_idx"], w["slot_idx"]):
            raise RuntimeError(f"{label}: call {i} routed to other slots "
                               f"than the unsharded run's")
    return [int((c["experts"] != c["replayed"]["experts"]).sum())
            for c in calls]


def _rank_slots(label: str, calls, want) -> tuple:
    """Check that every MoE call on a rank's rows of a split routing group
    (a seq2d prefill), replayed from the unsharded run's router logits
    sliced to those rows (``_routes``), routed them as the unsharded run
    did: the same experts, a pair kept where that run kept it, in the slot
    that run gave it less the group's offset (the pairs of the rows before
    this rank that chose that expert).  Returns, call by call, the pairs
    dropped only because of the rows before (the local queue place under
    the capacity, the global one at or over it) and the pairs whose expert
    the rank's own logits would have changed (printed, not gated)."""
    import torch
    if len(calls) != len(want):
        raise RuntimeError(f"{label}: {len(calls)} MoE calls sharded, "
                           f"{len(want)} unsharded")
    boundary, moved = [], []
    for i, (c, w) in enumerate(zip(calls, want)):
        r, start = c["replayed"], c["start"]
        b, s, k = r["experts"].shape
        e_pad, cap = w["slot_idx"].shape[1:]
        slots = r["slot_idx"].shape[-1]
        experts = w["experts"][:, start:start + s]
        slot = w["slot"][:, start:start + s]
        kept = slot < e_pad * cap
        before = torch.zeros((b, e_pad), dtype=torch.long,
                             device=experts.device).scatter_add_(
            1, w["experts"][:, :start].reshape(b, -1),
            torch.ones((b, start * k), dtype=torch.long,
                       device=experts.device))
        offset = torch.gather(before, 1, experts.reshape(b, -1)).reshape(
            b, s, k)
        if not (torch.equal(r["experts"], experts)
                and torch.equal(r["slot"] < e_pad * slots, kept)
                and torch.equal((r["slot"] % slots + offset)[kept],
                                (slot % cap)[kept])):
            raise RuntimeError(f"{label}: call {i} routed the rank's rows "
                               f"[{start}, {start + s}) to other slots "
                               f"than the unsharded run's")
        hot = torch.nn.functional.one_hot(experts.reshape(b, -1), e_pad)
        place = ((hot.cumsum(1) - hot) * hot).sum(-1).reshape(b, s, k)
        boundary.append(int(((place < cap) & (offset + place >= cap))
                            .sum()))
        moved.append(int((c["experts"] != r["experts"]).sum()))
    return boundary, moved


def tp_moe_serving(torch, rank: int, world: int, mesh,
                   runs=TP_MOE_RUNS) -> list:
    """Phase 20(f) and (g) on one rank, each config of ``TP_MOE_RUNS`` at
    full width (and (r), ``TP_MOE_SPLIT_RUNS``: under seq2d): its
    unsharded half (:func:`_moe_full_then_shards`), then the sharded
    prefill under the (1, 2) policy and the sharded serve steps on its
    cache, fed the unsharded run's tokens.  bf16 near-ties flip MoE
    routing, so every MoE call of the sharded run routes from the
    unsharded run's router logits, and its slots must equal that run's
    (under seq2d, each rank's rows with the queue offsets of the rows
    before it, :func:`_rank_slots`, whose pairs dropped only because of
    rank 0's counts are printed); the pairs its own logits would have
    routed elsewhere are printed.  This rank's vocab shard of the prefill
    logits, of each step's logits and exit logits within 5 % of
    max|logit| of the unsharded; the prefill's K5 launches as expected
    (under seq2d rank 1's on its query rows) and none in decode;
    all-reduces only.  Prints prefill s, decode ms a step, the
    collectives, the peak."""
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.roofline import torch_walk
    from repro_torch.tree import tree_leaves

    def kernels():
        return (fa.launches_tc, fa.launches, scan.lru_scan_gated.launches)

    def check(label, got, want, amax):
        d = float((got.float() - want.float()).abs().max())
        if tuple(got.shape) != tuple(want.shape) or \
                not d <= TP_LOGIT_RULE * amax:
            raise RuntimeError(f"20 {label} rank {rank}: {tuple(got.shape)} "
                               f"against the unsharded {tuple(want.shape)}, "
                               f"{d:.4f} apart, above {TP_LOGIT_RULE} x "
                               f"max|logit| {amax:.3f}")
        return d

    rows = []
    for part, arch, batch, prompt, gen, expected, over in runs:
        cfg = _tp_config(arch, **over)
        # under seq2d each rank prefills its rows: rank 1's on K5's
        # query-offset entry
        split = cfg.attn_shard == "seq2d"
        expected_rows = (expected[0], 0) if split and rank else (0, 0)
        if split and rank:
            expected = (0,) + tuple(expected[1:])
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                               generator=torch.Generator("cuda")
                               .manual_seed(1), device="cuda")
        lo, hi = sharding.shard_rows(cfg.vocab_size,
                                     mesh.get_local_rank("model"),
                                     mesh.size(1))
        u = _moe_full_then_shards(torch, rank, world, mesh, cfg, tokens,
                                  gen, lo, hi)
        params, (pre_calls, dec_calls) = u["shards"], u["calls"]
        amax_step = max(float(x.abs().max().float()) for x in u["steps"])
        amax_exit = max(float(x.abs().max().float()) for x in u["exit"])
        policy = sharding.MeshPolicy(mesh, cfg)
        prefill = steps.make_prefill_step(cfg, policy,
                                          cache_len=prompt + gen)
        torch.cuda.reset_peak_memory_stats()
        counter = torch_walk.Collectives()
        _tp_zero(ops, fa, scan)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with counter, _routes(pre_calls) as got_pre:
            logits, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = kernels()
        rows_launched = _split_rows(fa)
        if launched != expected or rows_launched != expected_rows:
            raise RuntimeError(f"20({part}) {arch} rank {rank}: launches K5 "
                               f"tc / K5 f32 / K6 gated {launched}, on query "
                               f"rows {rows_launched}, expected {expected}, "
                               f"{expected_rows}")
        label = f"20({part}) {arch} prefill rank {rank}"
        boundary = None
        if split:
            boundary, changed = _rank_slots(label, got_pre, pre_calls)
        else:
            changed = _replayed(label, got_pre, pre_calls)
        local = logits.to_local()
        want = u["want"]
        d = max(check(f"({part}) {arch}", local[i, j:j + 1024],
                      want[i, j:j + 1024], u["amax"])
                for i in range(batch) for j in range(0, prompt, 1024))
        row = {"part": part, "arch": arch, "params": u["params"],
               "local_params": sum(x.to_local().numel()
                                   for x in tree_leaves(params)),
               "batch": batch, "prompt": prompt, "init_s": u["init_s"],
               "unsharded_peak_gib": u["unsharded_peak_gib"],
               "held_gib": u["held_gib"], "prefill_s": wall,
               "max_abs_diff": d, "max_abs_logit": u["amax"],
               "prefill_pairs_changed_by_own_routing": sum(changed),
               "prefill_changed_by_layer": changed,
               "prefill_pairs_dropped_by_rows_before": boundary,
               "prefill_pairs": sum(c["experts"].numel() for c in got_pre),
               "logits_local": list(local.shape),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launched, "launches_rows": rows_launched,
               "launches_carry": 0, "collectives": counter.counts,
               "collective_bytes": counter.bytes}
        del logits, local, want, u["want"], got_pre, pre_calls
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counter = torch_walk.Collectives()
        fed = u["fed"]
        with counter, _routes(dec_calls) as got_dec:
            _, got_steps, got_exit, decode_s = _greedy_decode(
                torch, steps.make_serve_step(cfg, policy,
                                             with_exit_head=True),
                params, cache, fed[0], prompt, gen - 1, lo, hi, feed=fed)
        if kernels() != launched or _split_rows(fa) != rows_launched:
            raise RuntimeError(f"20({part}) {arch} rank {rank}: K5 / K6 "
                               f"launches {launched} after prefill, "
                               f"{kernels()} after decode (expected none in "
                               f"decode)")
        decode_changed = _replayed(f"20({part}) {arch} decode rank {rank}",
                                   got_dec, dec_calls)
        for c in (row["collectives"], counter.counts):
            if set(c) - {"all-reduce"}:
                raise RuntimeError(f"20({part}) {arch} rank {rank}: "
                                   f"collectives {c}: all-reduces only on "
                                   f"the card")
        steps_n = gen - 1
        row.update({
            "gen": gen, "decode_steps": steps_n,
            "decode_ms_per_step": decode_s / steps_n * 1e3,
            "unsharded_decode_ms_per_step": u["unsharded_s"] / steps_n
            * 1e3,
            "decode_max_abs_diff": max(check(
                f"({part}) {arch} step {i}", g, w, amax_step) for i, (g, w)
                in enumerate(zip(got_steps, u["steps"]))),
            "decode_max_abs_logit": amax_step,
            "exit_max_abs_diff": max(check(
                f"({part}) {arch} exit step {i}", g, w, amax_exit)
                for i, (g, w) in enumerate(zip(got_exit, u["exit"]))),
            "exit_max_abs_logit": amax_exit,
            "decode_pairs_changed_by_own_routing": sum(decode_changed),
            "decode_pairs": sum(c["experts"].numel() for c in got_dec),
            "decode_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "decode_collectives_per_step": {
                k: v / steps_n for k, v in counter.counts.items()},
            "decode_collective_bytes_per_step": {
                k: v / steps_n for k, v in counter.bytes.items()}})
        print(f"  ({part}) rank {rank} " + json.dumps(row), flush=True)
        rows.append(row)
        del params, cache, tokens, got_steps, got_exit, got_dec, dec_calls, u
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def tp_moe_card_vs_cpu(torch, rank: int, meshes: dict) -> dict:
    """Phase 20(h) on one rank: reduced qwen2-moe (``TP_MOE_NARROW``, f32)
    over the (1, 2) mesh, its train step (batch 2, 16 tokens) and its
    round (K = 2, one simple, 2 local steps) on the flat f32 and the flat
    int8 wires, each on the card's mesh and on the CPU's (the same gloo
    group): this rank's shards and the loss at rtol 1e-4 / atol 1e-5, the
    int8 round's shards under ``repro_torch.parity``'s rules as phase
    18(b) holds its int8 case; K1 and K2 counted on the card's runs."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import aggregate, comm
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map

    base = configs.get_reduced("qwen2-moe-a2.7b")
    cfg = base.with_overrides(
        head_dim=TP_MOE_NARROW["head_dim"], moe=dataclasses.replace(
            base.moe, d_expert=TP_MOE_NARROW["d_expert"]))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(6)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        2, 17)).astype(np.int32))
    data = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        2, 2, 2, 17)).astype(np.int32))
    simple = torch.tensor([True, False])
    int8 = aggregate.EngineSpec(wire=comm.WireSpec("int8", QB))
    sides, launched = {}, None
    for dev in ("cuda", "cpu"):
        mesh = meshes[dev]
        policy = sharding.MeshPolicy(mesh, cfg)
        _tp_zero(ops, fa, scan)
        got = {}
        new, metrics = steps.make_train_step(cfg, policy)(
            sharding.distribute_params(tree_map(lambda x: x.to(dev),
                                                params), cfg, mesh),
            {"tokens": tokens.to(dev)})
        got["train"] = ([x.to_local().cpu() for x in tree_leaves(new)],
                        metrics["loss"].cpu())
        for wire, engine in (("f32", None), ("int8", int8)):
            cohort = sharding.distribute_cohort(tree_map(
                lambda x: x.to(dev)[None].expand((2,) + x.shape), params),
                cfg, mesh)
            new_c, loss = steps.make_fed_round_step(
                cfg, policy, local_steps=2, engine=engine)(
                    cohort, data.to(dev), simple.to(dev))
            got[wire] = ([x.to_local().cpu() for x in tree_leaves(new_c)],
                         loss.cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = _tp_kernel_counts(ops, fa, scan)
        sides[dev] = got
    worst = {key: _tp_hold_rounds(torch, f"20(h) rank {rank} {key}", key,
                                  sides, params, cfg, meshes["cpu"])
             for key in ("train", "f32", "int8")}
    # K1 (the f32 round's fold), K2 (the int8 round's); no K5 in training
    want = (1, 1, 0, 0, 0, 0, 0)
    if launched != want:
        raise RuntimeError(f"20(h) rank {rank}: launches K1/K2/K3/K4/K5 tc/"
                           f"K5 f32/K6 {launched}, expected {want}")
    print(f"  (h) rank {rank}: reduced qwen2-moe train step and f32 / int8 "
          f"rounds, card against CPU, worst {worst}; launches {launched}",
          flush=True)
    return {"launches": launched, "worst": worst}


def tp_zoo_serving(torch, rank: int, mesh) -> list:
    """Phase 20(i) and (j) on one rank, each config of ``TP_ZOO_RUNS`` whole
    at its published widths (bf16, weights from seed 0): the unsharded
    prefill and ``gen - 1`` greedy serve steps with the exit head on this
    rank (run first, not counted), then the sharded prefill under the
    (1, 2) policy and the sharded serve steps on its cache, fed the
    unsharded run's tokens.  This rank's share of the prefill logits and
    of each step's logits and exit logits (xlstm's vocab rows, musicgen's
    codebooks: as the reference's constrain places them) within 5 % of
    max|logit| of the unsharded; the prefill's K5 / K6 launches as
    expected and none in decode; all-reduces only.  Prints the prefill s,
    the decode ms a step, the collectives a step, the peak and held GiB
    and the cache's placements."""
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.roofline import torch_walk
    from repro_torch.tree import tree_leaves

    def kernels():
        return (fa.launches_tc, fa.launches, scan.lru_scan_gated.launches)

    def check(label, got, want, amax):
        d = float((got.float() - want.float()).abs().max())
        if tuple(got.shape) != tuple(want.shape) or \
                not d <= TP_LOGIT_RULE * amax:
            raise RuntimeError(f"20 {label} rank {rank}: {tuple(got.shape)} "
                               f"against the unsharded {tuple(want.shape)}, "
                               f"{d:.4f} apart, above {TP_LOGIT_RULE} x "
                               f"max|logit| {amax:.3f}")
        return d

    rows = []
    for part, arch, batch, prompt, gen, expected, n_cond in TP_ZOO_RUNS:
        cfg = _tp_config(arch)
        codebooks = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        first_pos = n_cond + prompt
        cache_len = first_pos + gen
        torch.cuda.reset_peak_memory_stats()
        full = tfm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
        inputs = {"tokens": torch.randint(
            0, cfg.vocab_size, (batch, prompt) + codebooks,
            generator=torch.Generator("cuda").manual_seed(1),
            device="cuda")}
        if n_cond:
            inputs["extra_embeds"] = torch.randn(
                (batch, n_cond, cfg.frontend.d_in), device="cuda",
                generator=torch.Generator("cuda").manual_seed(2)).to(
                    cfg.torch_compute_dtype())
        want, cache = steps.make_prefill_step(cfg, cache_len=cache_len)(
            full, inputs)
        amax = float(want.abs().max().float())
        first = torch.argmax(want[:, -1], dim=-1)[:, None]
        fed, want_steps, want_exit, unsharded_s = _greedy_decode(
            torch, steps.make_serve_step(cfg, with_exit_head=True), full,
            cache, first, first_pos, gen - 1, 0, None)
        unsharded_peak = torch.cuda.max_memory_allocated() / 2**30
        amax_step = max(float(x.abs().max().float()) for x in want_steps)
        amax_exit = max(float(x.abs().max().float()) for x in want_exit)
        del cache
        gc.collect()
        torch.cuda.empty_cache()
        params = sharding.distribute_params(full, cfg, mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2**30
        policy = sharding.MeshPolicy(mesh, cfg)
        prefill = steps.make_prefill_step(cfg, policy, cache_len=cache_len)
        torch.cuda.reset_peak_memory_stats()
        counter = torch_walk.Collectives()
        _tp_zero(ops, fa, scan)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with counter:
            logits, cache = prefill(params, inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = kernels()
        if launched != expected:
            raise RuntimeError(f"20({part}) {arch} rank {rank}: launches K5 "
                               f"tc / K5 f32 / K6 gated {launched}, "
                               f"expected {expected}")
        local = logits.to_local()
        want = _local_slice(torch, want, logits)
        d = max(check(f"({part}) {arch}", local[i, j:j + 1024],
                      want[i, j:j + 1024], amax)
                for i in range(batch) for j in range(0, local.shape[1],
                                                     1024))
        row = {"part": part, "arch": arch, "params": sum(
            x.numel() for x in tree_leaves(params)), "local_params": sum(
            x.to_local().numel() for x in tree_leaves(params)),
               "batch": batch, "prompt": prompt, "conditioning": n_cond,
               "unsharded_peak_gib": unsharded_peak, "held_gib": held,
               "prefill_s": wall, "max_abs_diff": d, "max_abs_logit": amax,
               "logits_placements": str(logits.placements),
               "logits_local": list(local.shape),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launched, "collectives": counter.counts,
               "collective_bytes": counter.bytes}
        template = logits
        del logits, local, want
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counter = torch_walk.Collectives()
        with counter:
            _, got_steps, got_exit, decode_s = _greedy_decode(
                torch, steps.make_serve_step(cfg, policy,
                                             with_exit_head=True),
                params, cache, fed[0], first_pos, gen - 1, 0, None,
                feed=fed)
        if kernels() != launched:
            raise RuntimeError(f"20({part}) {arch} rank {rank}: K5 / K6 "
                               f"launches {launched} after prefill, "
                               f"{kernels()} after decode (expected none in "
                               f"decode)")
        for c in (row["collectives"], counter.counts):
            if set(c) - {"all-reduce"}:
                raise RuntimeError(f"20({part}) {arch} rank {rank}: "
                                   f"collectives {c}: all-reduces only on "
                                   f"the card")
        steps_n = gen - 1
        row.update({
            "gen": gen, "cache_len": cache_len, "decode_steps": steps_n,
            "decode_ms_per_step": decode_s / steps_n * 1e3,
            "unsharded_decode_ms_per_step": unsharded_s / steps_n * 1e3,
            "decode_max_abs_diff": max(check(
                f"({part}) {arch} step {i}", g, _local_slice(
                    torch, w, template), amax_step) for i, (g, w) in
                enumerate(zip(got_steps, want_steps))),
            "decode_max_abs_logit": amax_step,
            "exit_max_abs_diff": max(check(
                f"({part}) {arch} exit step {i}", g, _local_slice(
                    torch, w, template), amax_exit) for i, (g, w) in
                enumerate(zip(got_exit, want_exit))),
            "exit_max_abs_logit": amax_exit,
            "decode_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "decode_collectives_per_step": {
                k: v / steps_n for k, v in counter.counts.items()},
            "decode_collective_bytes_per_step": {
                k: v / steps_n for k, v in counter.bytes.items()},
            "cache_placements": sorted({str(x.placements) for x in
                                        tree_leaves(cache)})})
        print(f"  ({part}) rank {rank} " + json.dumps(row), flush=True)
        rows.append(row)
        del params, cache, inputs, template, got_steps, got_exit
        del want_steps, want_exit
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def tp_zoo_card_vs_cpu(torch, rank: int, meshes: dict) -> dict:
    """Phase 20(k) on one rank: reduced xlstm-1.3b and reduced
    musicgen-large (``TP_MUSICGEN_NARROW``; f32) over the (1, 2) mesh,
    each on the card's mesh and on the CPU's (the same gloo group): the
    train step (batch 2, 16 tokens; musicgen's with 4 conditioning rows),
    the f32 and int8 flat rounds (K = 2, one simple, 2 local steps), and
    a prefill of 16 tokens then 4 teacher-forced serve steps with the exit
    head.  This rank's shards and the losses at rtol 1e-4 / atol 1e-5, the
    int8 rounds under ``repro_torch.parity``'s rules; xlstm's training
    runs with its sLSTM output kept in f32 on both sides
    (``_f32_slstm_out``), and its logits, which follow that output's bf16
    cast in serving, within 5 % of max|logit| (phase 8's rule), its
    caches at rtol 1e-4 / atol 1e-5.  K1 and K2 once a config on the
    card's rounds, K5 f32 on a rank's heads in musicgen's prefill."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import aggregate, comm
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map

    int8 = aggregate.EngineSpec(wire=comm.WireSpec("int8", QB))
    launched, worst = None, {}
    _tp_zero(ops, fa, scan)
    for arch, over in ((XLSTM, {}), (MUSICGEN, TP_MUSICGEN_NARROW)):
        cfg = configs.get_reduced(arch).with_overrides(**over)
        nc = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(6)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
            2, 17) + nc).astype(np.int32))
        data = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
            2, 2, 2, 17) + nc).astype(np.int32))
        forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
            4, 2, 1) + nc).astype(np.int32))
        extra = {} if cfg.frontend is None else {
            "extra_embeds": torch.as_tensor(rng.standard_normal((
                2, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(
                    np.float32))}
        first = 16 + (0 if cfg.frontend is None else cfg.frontend.n_tokens)
        simple = torch.tensor([True, False])
        sides = {}
        for dev in ("cuda", "cpu"):
            mesh = meshes[dev]
            policy = sharding.MeshPolicy(mesh, cfg)
            ex = {k: v.to(dev) for k, v in extra.items()}
            got = {}
            with (_f32_slstm_out() if arch == XLSTM
                  else contextlib.nullcontext()):
                new, metrics = steps.make_train_step(cfg, policy)(
                    sharding.distribute_params(tree_map(
                        lambda x: x.to(dev), params), cfg, mesh),
                    {"tokens": tokens.to(dev), **ex})
                got["train"] = ([x.to_local().cpu()
                                 for x in tree_leaves(new)],
                                metrics["loss"].cpu())
                for wire, engine in (("f32", None), ("int8", int8)):
                    cohort = sharding.distribute_cohort(tree_map(
                        lambda x: x.to(dev)[None].expand((2,) + x.shape),
                        params), cfg, mesh)
                    new_c, loss = steps.make_fed_round_step(
                        cfg, policy, local_steps=2, engine=engine)(
                            cohort, data.to(dev), simple.to(dev))
                    got[wire] = ([x.to_local().cpu()
                                  for x in tree_leaves(new_c)], loss.cpu())
            placed = sharding.distribute_params(tree_map(
                lambda x: x.to(dev), params), cfg, mesh)
            logits, cache = steps.make_prefill_step(
                cfg, policy, cache_len=first + 4)(
                    placed, {"tokens": tokens[:, :16].to(dev), **ex})
            serve = steps.make_serve_step(cfg, policy, with_exit_head=True)
            heads = [logits.to_local().cpu()]
            for i in range(4):
                lg, cache, ex_lg = serve(placed, cache, {
                    "tokens": forced[i].to(dev)}, first + i)
                heads += [lg.to_local().cpu(), ex_lg.to_local().cpu()]
            got["serve"] = (heads, [x.to_local().cpu()
                                    for x in tree_leaves(cache)])
            if dev == "cuda":
                torch.cuda.synchronize()
                launched = _tp_kernel_counts(ops, fa, scan)
            sides[dev] = got
        for key in ("train", "f32", "int8"):
            worst[f"{arch} {key}"] = _tp_hold_rounds(
                torch, f"20(k) {arch} rank {rank} {key}", key, sides, params,
                cfg, meshes["cpu"])
        (heads_a, cache_a), (heads_b, cache_b) = (sides["cuda"]["serve"],
                                                  sides["cpu"]["serve"])
        _tp_allclose(torch, f"20(k) {arch} rank {rank} cache", cache_a,
                     cache_b)
        for i, (x, y) in enumerate(zip(heads_a, heads_b)):
            if arch != XLSTM:
                _tp_allclose(torch, f"20(k) {arch} rank {rank} logits {i}",
                             [x], [y])
                continue
            d = float((x - y).abs().max())
            if not d <= TP_LOGIT_RULE * float(y.abs().max()):
                raise RuntimeError(f"20(k) {arch} rank {rank}: logits {i} "
                                   f"{d:.4f} apart card vs CPU")
        worst[f"{arch} logits"] = max(float((x - y).abs().max())
                                      for x, y in zip(heads_a, heads_b))
    # per config: K1 (the f32 round's fold) and K2 (the int8 round's);
    # musicgen's prefill: K5 f32 on a rank's 2 of 4 heads, a layer each
    want = (2, 2, 0, 0, 0, 2, 0)
    if launched != want:
        raise RuntimeError(f"20(k) rank {rank}: launches K1/K2/K3/K4/K5 tc/"
                           f"K5 f32/K6 {launched}, expected {want}")
    print(f"  (k) rank {rank}: reduced xlstm-1.3b and musicgen-large train "
          f"step, f32 / int8 rounds, prefill and serve, card against CPU, "
          f"worst {worst}; launches {launched}", flush=True)
    return {"launches": launched, "worst": worst}


def _tp_allclose(torch, label: str, got: list, want: list) -> None:
    for x, y in zip(got, want):
        if not torch.allclose(x, y, rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"{label}: card against CPU max|diff| "
                               f"{float((x - y).abs().max()):.3e} (rtol "
                               f"1e-4, atol 1e-5)")


def _tp_hold_rounds(torch, label: str, key: str, sides: dict, params, cfg,
                    cpu_mesh) -> float:
    """Phase 20(h) and (k)'s rule for a narrow ``key`` run ("train", "f32"
    or "int8": ``(local shards, loss)`` on each side): the loss at rtol
    1e-4 / atol 1e-5; the shards at the same, or for the int8 round under
    ``repro_torch.parity``'s lossy-wire rules from the start ``params``
    placed on ``cpu_mesh``.  Returns the largest difference."""
    from repro_torch import parity
    from repro_torch.core import comm, flatten
    from repro_torch.launch import sharding
    from repro_torch.tree import tree_leaves, tree_map
    (a, la), (b, lb) = sides["cuda"][key], sides["cpu"][key]
    if not torch.allclose(la, lb, rtol=1e-4, atol=1e-5):
        raise RuntimeError(f"{label}: loss {float(la)} on the card, "
                           f"{float(lb)} on the CPU")
    if key != "int8":
        _tp_allclose(torch, label, a, b)
        return max(float((x - y).abs().max()) for x, y in zip(a, b))
    layout = flatten.build_layout(a, total_multiple=2048)
    fa, fb = flatten.pack(layout, a), flatten.pack(layout, b)
    spec = comm.WireSpec("int8", QB)
    start = [x.to_local().cpu() for x in tree_leaves(
        sharding.distribute_params(tree_map(lambda x: x.clone(), params),
                                   cfg, cpu_mesh))]
    bound = torch.maximum(parity.wire_step(spec, flatten.pack(layout, start)),
                          parity.wire_step(spec, fb))
    res = parity.lossy_compare(fa, fb, bound)
    if res["share"] > 1e-3 or res["worst"] > 1.0:
        raise RuntimeError(f"{label}: card vs CPU {res}")
    return res["max_abs"]


def tp_card_vs_cpu(torch, rank: int, meshes: dict) -> dict:
    """Phase 20(d) on one rank: a narrow f32 round (gemma2-2b reduced, K =
    2, one simple, 2 local steps) on the flat engine and the tree engine,
    and a narrow f32 prefill (minitron-8b reduced, heads sharded), each on
    the card's (1, 2) mesh and on the CPU's (the same gloo group), this
    rank's shards and the loss at rtol 1e-4 / atol 1e-5; K1, K4 and K5 (f32)
    counted on the card's runs."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import aggregate
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map

    cfg = configs.get_reduced(STEP_ARCH)
    pcfg = configs.get_reduced("minitron-8b")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    pparams = tfm.init_params(torch.Generator().manual_seed(0), pcfg)
    rng = np.random.default_rng(5)
    data = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        2, 2, 2, 17)).astype(np.int32))
    simple = torch.tensor([True, False])
    prompt = torch.as_tensor(rng.integers(0, pcfg.vocab_size, size=(
        2, 32)).astype(np.int32))
    sides, launched = {}, None
    for dev in ("cuda", "cpu"):
        mesh = meshes[dev]
        _tp_zero(ops, fa, scan)
        got = {}
        for engine in ("flat", "tree"):
            cohort = sharding.distribute_cohort(tree_map(
                lambda x: x.to(dev)[None].expand((2,) + x.shape), params),
                cfg, mesh)
            new_c, loss = steps.make_fed_round_step(
                cfg, sharding.MeshPolicy(mesh, cfg), local_steps=2,
                engine=aggregate.EngineSpec(engine=engine))(
                    cohort, data.to(dev), simple.to(dev))
            got[engine] = ([x.to_local().cpu() for x in
                            tree_leaves(new_c)], loss.cpu())
        logits, _ = steps.make_prefill_step(
            pcfg, sharding.MeshPolicy(mesh, pcfg))(
                sharding.distribute_params(tree_map(
                    lambda x: x.to(dev), pparams), pcfg, mesh),
                {"tokens": prompt.to(dev)})
        got["prefill"] = ([logits.to_local().cpu()], torch.zeros(()))
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = _tp_kernel_counts(ops, fa, scan)
        sides[dev] = got
    worst = 0.0
    for key in ("flat", "tree", "prefill"):
        (a, la), (b, lb) = sides["cuda"][key], sides["cpu"][key]
        for x, y in zip(a + [la], b + [lb]):
            if not torch.allclose(x, y, rtol=1e-4, atol=1e-5):
                raise RuntimeError(f"20(d) rank {rank} {key}: card against "
                                   f"CPU max|diff| "
                                   f"{float((x - y).abs().max()):.3e} "
                                   f"(rtol 1e-4, atol 1e-5)")
            worst = max(worst, float((x - y).abs().max()))
    # K1 (flat), K4 (tree), K5 on the CUDA cores (two f32 layers)
    want = (1, 0, 0, 1, 0, 2, 0)
    if launched != want:
        raise RuntimeError(f"20(d) rank {rank}: launches K1/K2/K3/K4/K5 tc/"
                           f"K5 f32/K6 {launched}, expected {want}")
    print(f"  (d) rank {rank}: narrow round (flat, tree) and prefill, card "
          f"against CPU, worst {worst:.3e}; launches {launched}", flush=True)
    return {"launches": launched, "worst": worst}


# phase 20(l), (m): gemma2-2b at published widths (arXiv:2408.00118) under
#  the token splits over the (1, 2) mesh, each (part, mode, batch, prompt,
#  new tokens): phase 7's serving cell (batch 1, prompt 8192) under seq2d,
#  each rank prefilling its 4096 query rows (K5 at q_offset 0 and 4096
#  against the key prefix it can see), then 7 serve steps with the exit
#  head on the heads-split cache; under dp2d at batch 2, one sequence a
#  rank (K5 at phase 7's shape).  Weights replicated (5.23 GB a rank)
TP_SPLIT_RUNS = (("l", STEP_ARCH, "seq2d", 1, 8192, 8),
                 ("m", STEP_ARCH, "dp2d", 2, 8192, 8))
# phase 20(o): recurrentgemma-2b at published widths under seq2d on phase
#  7's cell (batch 4, prompt 4096): each rank prefills its 2048 rows, the
#  RG-LRU layers' conv halo and K6's carry from rank 0 (K6's carried
#  entry on both ranks, rank 1 from rank 0's y_last), the local attention
#  (window 2048, one kv head) on K5's query-offset entry on rank 1; then
#  7 serve steps with the exit head on the kv_seq ring and the RG-LRU
#  state over 1280 of 2560 channels
TP_HYBRID_RUNS = (("o", "recurrentgemma-2b", "seq2d", 4, 4096, 8),)
# phase 20(n): reduced gemma2-2b under seq2d and dp2d and reduced
#  llava-next-34b under seq2d_fsdp, card against CPU: the train step, the
#  rounds (the token splits; a seq2d_fsdp cohort is refused), a prefill of
#  TP_SPLIT_PROMPT positions (llava's 8 frontend rows included; cut from
#  4096 for the smoke's time) and 6 serve steps
TP_SPLIT_PROMPT = 2048
TP_SPLIT_ENGINES = ("f32", "int8", "tree", "int8 topk", "scaffold")
# each (arch, mode, round engines, prompt positions)
TP_SPLIT_NARROW = (("gemma2-2b", "seq2d", TP_SPLIT_ENGINES, TP_SPLIT_PROMPT),
                   ("gemma2-2b", "dp2d", TP_SPLIT_ENGINES, TP_SPLIT_PROMPT),
                   ("llava-next-34b", "seq2d_fsdp", TP_SPLIT_ENGINES,
                    TP_SPLIT_PROMPT))
# phase 20(p): reduced recurrentgemma-2b and musicgen-large (f32) under
#  seq2d and dp2d, card against CPU as (n): the train step, the f32, int8
#  and tree rounds, a prefill of 256 positions (musicgen's 4 conditioning
#  rows included: 128 rows a rank under seq2d) and 6 serve steps.  The
#  RG-LRU's state carries each device's rounding along the sequence: at
#  1024 positions the unsharded narrow prefill itself leaves rtol 1e-4 /
#  atol 1e-5 card against CPU, at 256 it holds
TP_HYBRID_ENGINES = ("f32", "int8", "tree")
TP_HYBRID_NARROW = tuple((arch, mode, TP_HYBRID_ENGINES, 256)
                         for arch in ("recurrentgemma-2b", "musicgen-large")
                         for mode in ("seq2d", "dp2d"))
# K5 on a rank's query rows (the kernels' q_offset), held to the plain
# version and timed: (label, B, Sq, q_offset, H, Kh, Dh, window, softcap,
# dtype); the keys are the q_offset + Sq a rank's rows can see.  (l)'s
# shapes, global and at gemma2's window, a reduced gemma2-2b f32 rank-1
# prefill of 4096 positions, and (o)'s rank 1
TP_ROWS_CASES = (
    ("gemma2-2b global, rank 0's rows", 1, 4096, 0, 8, 4, 256, 0, 0.0,
     "bfloat16"),
    ("gemma2-2b global, rank 1's rows", 1, 4096, 4096, 8, 4, 256, 0, 0.0,
     "bfloat16"),
    ("gemma2-2b window 4096, rank 0's rows", 1, 4096, 0, 8, 4, 256, 4096,
     0.0, "bfloat16"),
    ("gemma2-2b window 4096, rank 1's rows", 1, 4096, 4096, 8, 4, 256, 4096,
     0.0, "bfloat16"),
    ("reduced gemma2-2b in f32, rank 1's rows", 2, 2048, 2048, 4, 2, 32, 0,
     0.0, "float32"),
    ("recurrentgemma-2b window 2048, rank 1's rows", 4, 2048, 2048, 10, 1,
     256, 2048, 0.0, "bfloat16"),
    ("qwen2-moe-a2.7b, rank 1's rows", 1, 2048, 2048, 16, 16, 128, 0, 0.0,
     "bfloat16"))


def check_flash_rows(torch, bw: float, cases=TP_ROWS_CASES) -> dict:
    """K5's kernels on a rank's query rows: each case's call against the
    plain version on the same inputs (``_close`` at check_flash's rules)
    and checked to launch its dtype's kernel once (the rows counter past
    q_offset 0), then timed (``time_ms``, a CUDA graph) beside the plain
    version and SDPA with the same boolean mask.  The bound counts the kept
    pairs (``ops.causal_pairs`` with the offset) at the route's peak and
    q, the key prefix, v and out once at the HBM rate."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    fa = ops.flash_attention
    worst = {"bfloat16": 0.0, "float32": 0.0}
    timing = []
    for label, b, sq, off, h, kh, dh, window, cap, dtype in cases:
        sk = off + sq
        g = torch.Generator(device="cuda").manual_seed(sk + h + off)
        dt = getattr(torch, dtype)
        q = (torch.randn((b, sq, h, dh), generator=g, device="cuda") * 2
             ).to(dt)
        k = (torch.randn((b, sk, kh, dh), generator=g, device="cuda") * 2
             ).to(dt)
        v = torch.randn((b, sk, kh, dh), generator=g, device="cuda").to(dt)
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7
        route, peak, _ = FLASH_ROUTES[dtype]
        counter = ("launches_tc" if dtype == "bfloat16" else "launches") + (
            "_rows" if off else "")
        before = getattr(fa, counter)

        def call():
            return fa(q, k, v, window=window, softcap=cap, q_offset=off)
        got = call()
        if getattr(fa, counter) != before + 1:
            raise RuntimeError(f"flash_attention {label}: {dtype} did not "
                               f"launch the {route} kernel once "
                               f"({counter})")
        want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap,
                                       q_offset=off)
        worst[dtype] = max(worst[dtype], _close(
            torch, f"flash_attention rows [{route}] {label} "
            f"{(b, sq, h, kh, dh)} q_offset {off} of {sk} keys, window "
            f"{window}", got, want, tol, tol))
        del got, want
        pairs = ops.causal_pairs(sq, window, off)
        flops = 4 * dh * pairs * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / bw * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        ms = time_ms(torch, call, iters=10, warmup=2)
        plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, window=window, softcap=cap, q_offset=off), iters=3,
            warmup=1)
        qpos = off + torch.arange(sq, device="cuda")
        kpos = torch.arange(sk, device="cuda")
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(h // kh, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(h // kh, dim=2).transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        library_ms = time_ms(torch, lib, iters=5, warmup=2)
        row = {"case": label, "route": route,
               "shape": {"B": b, "Sq": sq, "q_offset": off, "Sk": sk,
                         "H": h, "Kh": kh, "Dh": dh, "window": window,
                         "softcap": cap, "dtype": dtype},
               "ms": ms, "plain_ms": plain_ms, "pairs": pairs,
               "flops": flops, "bytes_needed": nbytes, "peak_flops": peak,
               "bound_ms": bound_ms, "bound_share": bound_ms / ms,
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "tflops": flops / ms / 1e9, "library_ms": library_ms,
               "library_max_abs_diff": float((lib().transpose(1, 2).float()
                                              - call().float()).abs().max())}
        print(f"  flash_attention rows [{route}] {label}: kernel {ms:.4f} ms "
              f"({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({row['bound_by']}; {pairs:,} pairs "
              f"x {b * h} heads), bound share {bound_ms / ms:.4f}, SDPA "
              f"{library_ms:.4f} ms", flush=True)
        timing.append(row)
        del q, k, v, qt, kt, vt, mask
    return {"max_abs_err": worst, "timing": timing}


def _local_part(full, placements, mesh):
    """The part of the full tensor ``full`` that a DTensor placed by
    ``placements`` over ``mesh`` holds on this rank (shards nested in mesh
    order, as DTensor splits them)."""
    from repro_torch.launch import sharding
    for i, pl in enumerate(placements):
        if pl.is_shard():
            lo, hi = sharding.shard_rows(full.shape[pl.dim],
                                         mesh.get_local_rank(i),
                                         mesh.size(i))
            full = full.narrow(pl.dim, lo, hi - lo)
    return full


def _split_rows(fa) -> tuple:
    """K5's launches on a rank's query rows: tensor cores, CUDA cores."""
    return fa.launches_tc_rows, fa.launches_rows


def tp_split_serving(torch, rank: int, mesh,
                     runs=TP_SPLIT_RUNS) -> list:
    """Phase 20(l) and (m) on one rank, each run of ``TP_SPLIT_RUNS``
    (and (o), ``TP_HYBRID_RUNS``): the config at published widths under
    the mode, first unsharded on this
    rank (the ranks in turn, a barrier between: (m)'s batch-2 logits are
    8.4 GB a rank), prefilled and served ``gen - 1`` greedy steps with the
    exit head, keeping the part of each logits tensor that the sharded run
    places on this rank; then the sharded prefill (``cache_len`` prompt +
    gen) and serve steps on its cache, fed the unsharded run's tokens.
    Logits and exit logits within 5 % of max|logit| of the unsharded; the
    prefill's K5 launches, one an attention layer (on this rank's query
    rows under seq2d: the rows counter on rank 1), and K6's, one an RG-LRU
    layer (its carried entry under seq2d), and none of either in decode;
    all-reduces only.  Prints
    prefill s, decode ms a step, the all-reduces and their bytes (prefill,
    a decode step) and the peak and held GiB."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.roofline import torch_walk
    from repro_torch.tree import tree_leaves

    def check(label, got, want, amax):
        d = float((got.float() - want.float()).abs().max())
        if tuple(got.shape) != tuple(want.shape) or \
                not d <= TP_LOGIT_RULE * amax:
            raise RuntimeError(f"20 {label} rank {rank}: {tuple(got.shape)} "
                               f"against the unsharded {tuple(want.shape)}, "
                               f"{d:.4f} apart, above {TP_LOGIT_RULE} x "
                               f"max|logit| {amax:.3f}")
        return d

    def placed(x, policy):
        return sharding.to_placements(policy.spec(tuple(x.shape), (
            "batch", "seq", "vocab")), mesh)

    rows = []
    for part, arch, mode, batch, prompt, gen in runs:
        cfg = _tp_config(arch, attn_shard=mode)
        policy = sharding.MeshPolicy(mesh, cfg)
        cache_len = prompt + gen
        full = tokens = None
        for turn in range(mesh.size(1)):
            if turn == rank:
                full = tfm.init_params(torch.Generator("cuda").manual_seed(
                    0), cfg)
                tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                       generator=torch.Generator("cuda")
                                       .manual_seed(1), device="cuda")
                want, cache = steps.make_prefill_step(
                    cfg, cache_len=cache_len)(full, {"tokens": tokens})
                amax = float(want.abs().max().float())
                tok = torch.argmax(want[:, -1], dim=-1)[:, None]
                place = placed(want, policy)
                want = _local_part(want, place, mesh).clone()
                serve0 = steps.make_serve_step(cfg, with_exit_head=True)
                fed, want_steps, want_exit = [], [], []
                torch.cuda.synchronize()
                t = time.perf_counter()
                for i in range(gen - 1):
                    fed.append(tok)
                    lg, cache, ex = serve0(full, cache, {"tokens": tok},
                                           prompt + i)
                    want_steps.append(_local_part(lg, placed(lg, policy),
                                                  mesh).clone())
                    want_exit.append(_local_part(ex, placed(ex, policy),
                                                 mesh).clone())
                    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
                torch.cuda.synchronize()
                unsharded_s = time.perf_counter() - t
                del cache, lg, ex
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        amax_step = max(float(x.abs().max().float()) for x in want_steps)
        amax_exit = max(float(x.abs().max().float()) for x in want_exit)
        params = sharding.distribute_params(full, cfg, mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        prefill = steps.make_prefill_step(cfg, policy, cache_len=cache_len)
        torch.cuda.reset_peak_memory_stats()
        counter = torch_walk.Collectives()
        _tp_zero(ops, fa, scan)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with counter:
            logits, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = (fa.launches_tc, fa.launches, scan.lru_scan_gated.launches)
        rows_launched = _split_rows(fa)
        carried = scan.lru_scan_gated.launches_carry
        # one K5 launch an attention layer, one K6 launch an RG-LRU layer:
        # under seq2d rank 1's rows start past 0, and K6 carries its state
        n_attn, n_rglru = _mixer_counts(cfg)
        want_rows = n_attn if mode == "seq2d" and rank else 0
        want_carry = n_rglru if mode == "seq2d" else 0
        if launched != (n_attn - want_rows, 0, n_rglru) or \
                rows_launched != (want_rows, 0) or carried != want_carry:
            raise RuntimeError(f"20({part}) rank {rank}: K5 tc / f32 / K6 "
                               f"{launched}, on query rows {rows_launched}, "
                               f"K6 carried {carried}")
        if [str(p) for p in logits.placements] != [str(p) for p in place]:
            raise RuntimeError(f"20({part}) rank {rank}: logits placed "
                               f"{logits.placements}, not {place}")
        local = logits.to_local()
        d = max(check(f"({part}) prefill", local[i, j:j + 1024],
                      want[i, j:j + 1024], amax)
                for i in range(local.shape[0])
                for j in range(0, prompt, 1024))
        peak = torch.cuda.max_memory_allocated() / 2**30
        row = {"part": part, "arch": arch, "mode": mode,
               "n_layers": cfg.n_layers,
               "batch": batch, "prompt": prompt, "prefill_s": wall,
               "max_abs_diff": d, "max_abs_logit": amax,
               "logits_local": list(local.shape), "peak_gib": peak,
               "launches": launched, "launches_rows": rows_launched,
               "launches_carry": carried,
               "collectives": counter.counts,
               "collective_bytes": counter.bytes}
        del logits, local, want
        gc.collect()
        torch.cuda.empty_cache()
        if mode == "seq2d" and _xlstm_layers(cfg):
            # once more, each xLSTM layer and its own scan timed
            with _chain_clock(torch) as clock:
                prefill(params, {"tokens": tokens})
            row["chain_ms_per_layer"] = clock
            print(f"  ({part}) rank {rank}: the chain a layer, ms (mixer "
                  f"on this rank's rows, waits included; this rank's own "
                  f"scan): {json.dumps(clock)}", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        row["held_gib"] = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        counter = torch_walk.Collectives()
        serve = steps.make_serve_step(cfg, policy, with_exit_head=True)
        got_steps, got_exit = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        with counter:
            for i in range(gen - 1):
                lg, cache, ex = serve(params, cache, {"tokens": fed[i]},
                                      prompt + i)
                got_steps.append(lg.to_local().clone())
                got_exit.append(ex.to_local().clone())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        if (fa.launches_tc, fa.launches, scan.lru_scan_gated.launches) + \
                _split_rows(fa) != launched + rows_launched:
            raise RuntimeError(f"20({part}) rank {rank}: K5 or K6 launched "
                               f"in decode")
        for c in (row["collectives"], counter.counts):
            if set(c) - {"all-reduce"}:
                raise RuntimeError(f"20({part}) rank {rank}: collectives "
                                   f"{c}: all-reduces only on the card")
        steps_n = gen - 1
        row.update({
            "gen": gen, "cache_len": cache_len, "decode_steps": steps_n,
            "decode_ms_per_step": decode_s / steps_n * 1e3,
            "unsharded_decode_ms_per_step": unsharded_s / steps_n * 1e3,
            "decode_max_abs_diff": max(check(
                f"({part}) step {i}", g, w, amax_step) for i, (g, w) in
                enumerate(zip(got_steps, want_steps))),
            "decode_max_abs_logit": amax_step,
            "exit_max_abs_diff": max(check(
                f"({part}) exit step {i}", g, w, amax_exit) for i, (g, w) in
                enumerate(zip(got_exit, want_exit))),
            "exit_max_abs_logit": amax_exit,
            "decode_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "decode_collectives_per_step": {
                k: v / steps_n for k, v in counter.counts.items()},
            "decode_collective_bytes_per_step": {
                k: v / steps_n for k, v in counter.bytes.items()},
            "cache_placements": sorted({str(x.placements) for x in
                                        tree_leaves(cache)})})
        print(f"  ({part}) rank {rank} " + json.dumps(row), flush=True)
        rows.append(row)
        del params, cache, tokens, got_steps, got_exit, want_steps, want_exit
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def tp_split_card_vs_cpu(torch, rank: int, meshes: dict,
                         narrow=TP_SPLIT_NARROW, part: str = "n") -> dict:
    """Phase 20(n) on one rank (and (p), ``TP_HYBRID_NARROW``, and (s),
    ``TP_MOE_SPLIT_NARROW``): each config and mode of ``narrow`` (f32,
    with its MoE overrides) on the card's (1, 2) mesh and on the CPU's
    (the same gloo group): the train step (batch 2, 16 tokens; a
    frontend's rows too, each codebook's tokens; an MoE config's aux
    losses in its loss, and on the card the pairs each rank's split
    routing groups drop that a routing of its own rows would keep,
    printed); under seq2d and dp2d
    the rounds of its engines (K = 2, one simple, 2 local steps), and on
    the card the int8 top-k round bitwise the int8 round and the SCAFFOLD
    round bitwise the f32 one where both run; under seq2d_fsdp the
    cohort's refusal (its specs name data twice); a prefill of its
    prompt positions then 6 teacher-forced serve steps with the exit
    head.  This rank's shards, losses, logits and caches at rtol 1e-4 /
    atol 1e-5, the int8 rounds under ``repro_torch.parity``'s rules.  K1,
    K2, K4, K5 f32 (whole sequences and a rank's query rows) and K6 (its
    carried entry under seq2d) counted per config on the card's runs."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import aggregate, comm
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map

    engines = {"f32": None,
               "int8": aggregate.EngineSpec(wire=comm.WireSpec("int8", QB)),
               "tree": aggregate.EngineSpec(engine="tree"),
               "int8 topk": aggregate.EngineSpec(wire=comm.WireSpec(
                   "int8", QB, topk_frac=0.5)),
               "scaffold": aggregate.EngineSpec(
                   variance_reduction="scaffold")}
    launched, worst, refused, drops = {}, {}, None, {}
    for arch, mode, run_engines, positions, *moe_over in narrow:
        cfg = configs.get_reduced(arch).with_overrides(attn_shard=mode)
        if moe_over and moe_over[0]:
            cfg = cfg.with_overrides(moe=dataclasses.replace(
                cfg.moe, **moe_over[0]))
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(7)
        n_extra = 0 if cfg.frontend is None else cfg.frontend.n_tokens
        nc = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
            2, 17) + nc).astype(np.int32))
        data = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
            2, 2, 2, 17) + nc).astype(np.int32))
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
            2, positions - n_extra) + nc).astype(np.int32))
        forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
            6, 2, 1) + nc).astype(np.int32))
        extra = {} if cfg.frontend is None else {
            "extra_embeds": torch.as_tensor(rng.standard_normal((
                2, n_extra, cfg.frontend.d_in)).astype(np.float32))}
        simple = torch.tensor([True, False])
        sides = {}
        # xlstm's sLSTM output kept in f32 (every step held at f32 rules)
        f32_out = _f32_slstm_out if cfg.arch_type == "ssm" else \
            contextlib.nullcontext
        for dev in ("cuda", "cpu"):
            mesh = meshes[dev]
            policy = sharding.MeshPolicy(mesh, cfg)
            ex = {k: v.to(dev) for k, v in extra.items()}
            with f32_out():
                _tp_zero(ops, fa, scan)
                fa.launches_tc_rows = fa.launches_rows = 0
                got = {}
                with _boundary_drops() as dropped:
                    new, metrics = steps.make_train_step(cfg, policy)(
                        sharding.distribute_params(tree_map(
                            lambda x: x.to(dev), params), cfg, mesh),
                        {"tokens": tokens.to(dev), **ex})
                if dev == "cuda" and dropped:
                    drops[f"{arch} {mode}"] = dropped
                got["train"] = ([x.to_local().cpu() for x in tree_leaves(new)],
                                metrics["loss"].cpu())
                for name in run_engines:
                    stacked = tree_map(lambda x: x.to(dev)[None].expand(
                        (2,) + x.shape), params)
                    try:
                        cohort = sharding.distribute_cohort(stacked, cfg, mesh)
                    except ValueError as e:
                        if mode != "seq2d_fsdp":
                            raise
                        refused = str(e)
                        break
                    new_c, loss = steps.make_fed_round_step(
                        cfg, policy, local_steps=2, engine=engines[name])(
                            cohort, data.to(dev), simple.to(dev))
                    got[name] = ([x.to_local().cpu() for x in
                                  tree_leaves(new_c)], loss.cpu())
                placed = sharding.distribute_params(tree_map(
                    lambda x: x.to(dev), params), cfg, mesh)
                logits, cache = steps.make_prefill_step(
                    cfg, policy, cache_len=positions + 6)(
                        placed, {"tokens": prompt.to(dev), **ex})
                serve = steps.make_serve_step(cfg, policy, with_exit_head=True)
                heads = [logits.to_local().cpu()]
                for i in range(6):
                    lg, cache, ex_lg = serve(placed, cache, {
                        "tokens": forced[i].to(dev)}, positions + i)
                    heads += [lg.to_local().cpu(), ex_lg.to_local().cpu()]
                got["serve"] = (heads, [x.to_local().cpu()
                                        for x in tree_leaves(cache)])
            if dev == "cuda":
                torch.cuda.synchronize()
                launched[f"{arch} {mode}"] = (
                    _tp_kernel_counts(ops, fa, scan), _split_rows(fa),
                    scan.lru_scan_gated.launches_carry)
            sides[dev] = got
        label = f"20({part}) {arch} {mode} rank {rank}"
        keys = ["train"] + [k for k in run_engines if k in sides["cpu"]]
        for key in keys:
            wire = "int8" if key.startswith("int8") else "f32"
            view = {dev: {wire if key != "train" else key: sides[dev][key]}
                    for dev in sides}
            worst[f"{arch} {mode} {key}"] = _tp_hold_rounds(
                torch, f"{label} {key}", wire if key != "train" else key,
                view, params, cfg, meshes["cpu"])
        # the reference's round step folds no sparse chunk and no control
        # variates: the extra options change nothing, bitwise
        for key, base in (("int8 topk", "int8"), ("scaffold", "f32")):
            if key not in sides["cuda"] or base not in sides["cuda"]:
                continue
            (a, la), (b, lb) = sides["cuda"][key], sides["cuda"][base]
            if not (torch.equal(la, lb) and all(
                    torch.equal(x, y) for x, y in zip(a, b))):
                raise RuntimeError(f"{label}: the {key} round is not the "
                                   f"{base} round bitwise on the card")
        (heads_a, cache_a), (heads_b, cache_b) = (sides["cuda"]["serve"],
                                                  sides["cpu"]["serve"])
        _tp_allclose(torch, f"{label} cache", cache_a, cache_b)
        _tp_allclose(torch, f"{label} logits", heads_a, heads_b)
        worst[f"{arch} {mode} serve"] = max(
            float((x - y).abs().max()) for x, y in zip(heads_a + cache_a,
                                                      heads_b + cache_b))
        # K5 f32 an attention layer in prefill (under seq2d and seq2d_fsdp
        # rank 1's rows start past 0), K6 an RG-LRU layer (carried under
        # seq2d); the rounds' folds under seq2d and dp2d
        rounds = mode != "seq2d_fsdp"
        n_attn, n_rglru = _mixer_counts(cfg)
        on_rows = n_attn if mode != "dp2d" and rank else 0
        folds = tuple(sum(e in names for e in run_engines) if rounds else 0
                      for names in (("f32", "scaffold"),
                                    ("int8", "int8 topk"), (), ("tree",)))
        want = (folds + (0, n_attn - on_rows, n_rglru), (0, on_rows),
                n_rglru if mode != "dp2d" else 0)
        if launched[f"{arch} {mode}"] != want:
            raise RuntimeError(f"{label}: launches K1/K2/K3/K4/K5 tc/K5 "
                               f"f32/K6, K5 on query rows, K6 carried "
                               f"{launched[f'{arch} {mode}']}, expected "
                               f"{want}")
    fsdp = any(c[1] == "seq2d_fsdp" and c[2] for c in narrow)
    if fsdp and (refused is None or "'data' to two dims" not in refused):
        raise RuntimeError(f"20({part}) rank {rank}: the seq2d_fsdp cohort "
                           f"was not refused ({refused})")
    print(f"  ({part}) rank {rank}: "
          f"{sorted({(c[0], c[1]) for c in narrow})}: train step, "
          f"rounds, prefill and serve, card against CPU, worst {worst}; "
          f"launches {launched}; the seq2d_fsdp round refused: {refused}"
          + (f"; the card's train step's MoE layers, the pairs this rank "
             f"dropped that a routing of its own rows would keep, and "
             f"those it kept that that routing drops, by layer: {drops}"
             if drops else ""), flush=True)
    return {"launches": launched, "worst": worst, "refused": refused,
            "boundary_drops": drops}


@contextlib.contextmanager
def _boundary_drops():
    """Wrap ``mlp._route`` for one run: yields a list that gets, for each
    call on a rank's part of a routing group split over ranks, ``(pairs
    the group's routing dropped that a routing of this rank's tokens alone
    (their own capacity, no offsets) keeps, pairs it kept that that
    routing drops)``."""
    from repro_torch.models import mlp
    route, calls = mlp._route, []

    def wrapped(logits, moe, capacity, e_pad=0, group=None):
        r = route(logits, moe, capacity, e_pad, group)
        if group is not None and group.dims:
            alone = route(logits.detach(), moe,
                          mlp._capacity(moe, logits.shape[1]), e_pad)
            kept = r.token_slot < r.slot_idx.shape[1] * r.slot_idx.shape[2]
            kept_alone = alone.token_slot < (alone.slot_idx.shape[1]
                                             * alone.slot_idx.shape[2])
            calls.append((int((kept_alone & ~kept).sum()),
                          int((kept & ~kept_alone).sum())))
        return r
    mlp._route = wrapped
    try:
        yield calls
    finally:
        mlp._route = route


def tp_moe_group_card_vs_cpu(torch, rank: int) -> dict:
    """Phase 20(t) on one rank: the two ranks as a (2, 1) mesh on the card
    and on the CPU (the same gloo group), each config f32: reduced
    qwen2-moe's prefill (batch 2, ``TP_GROUP_PROMPT`` positions) and 6
    teacher-forced serve steps with the exit head, decode's one routing
    group split over data (this rank's row routed with the queue offsets
    of the rank before it); reduced kimi-k2 with 2-D experts (expert_ffn
    over data, gathered there by ``common.redistribute_by_sum``): its
    train step (batch 2, 16 tokens), prefill and 6 serve steps.  This
    rank's shards, losses, logits and caches at rtol 1e-4 / atol 1e-5; the
    steps' collectives (``torch_walk.Collectives``) all-reduces only, none
    an all-gather; K5 f32 once an attention layer a prefill on the card."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.roofline import torch_walk
    from repro_torch.tree import tree_leaves, tree_map

    meshes = {dev: make_device_mesh(2, 1, dev) for dev in ("cuda", "cpu")}
    cfgs = {"qwen2-moe-a2.7b": configs.get_reduced("qwen2-moe-a2.7b"),
            "kimi-k2-1t-a32b 2-D": configs.get_reduced(
                "kimi-k2-1t-a32b").with_overrides(shard_experts_2d=True)}
    rng = np.random.default_rng(8)
    sides, collectives, placements = {}, {}, {}
    for dev in ("cuda", "cpu"):
        mesh = meshes[dev]
        _tp_zero(ops, fa, scan)
        got = {}
        for name, cfg in cfgs.items():
            params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
            seeds = np.random.default_rng(9)
            tokens = torch.as_tensor(seeds.integers(
                0, cfg.vocab_size, size=(2, 17)).astype(np.int32))
            prompt = torch.as_tensor(seeds.integers(
                0, cfg.vocab_size, size=(2, TP_GROUP_PROMPT)).astype(
                    np.int32))
            forced = torch.as_tensor(seeds.integers(
                0, cfg.vocab_size, size=(6, 2, 1)).astype(np.int32))
            policy = sharding.MeshPolicy(mesh, cfg)
            counter = torch_walk.Collectives()
            if name.startswith("kimi"):
                placed = sharding.distribute_params(tree_map(
                    lambda x: x.to(dev), params), cfg, mesh)
                placements[name] = str(placed["periods"][0]["mlp"][
                    "experts"]["gate"].placements)
                with counter:
                    new, metrics = steps.make_train_step(cfg, policy)(
                        placed, {"tokens": tokens.to(dev)})
                got[name + " train"] = (
                    [x.to_local().cpu() for x in tree_leaves(new)],
                    metrics["loss"].cpu())
            placed = sharding.distribute_params(tree_map(
                lambda x: x.to(dev), params), cfg, mesh)
            with counter:
                logits, cache = steps.make_prefill_step(
                    cfg, policy, cache_len=TP_GROUP_PROMPT + 6)(
                        placed, {"tokens": prompt.to(dev)})
                serve = steps.make_serve_step(cfg, policy,
                                              with_exit_head=True)
                heads = [logits.to_local().cpu()]
                for i in range(6):
                    lg, cache, ex = serve(placed, cache, {
                        "tokens": forced[i].to(dev)}, TP_GROUP_PROMPT + i)
                    heads += [lg.to_local().cpu(), ex.to_local().cpu()]
            got[name + " serve"] = (heads, [x.to_local().cpu()
                                            for x in tree_leaves(cache)])
            if dev == "cuda":
                collectives[name] = (counter.counts, counter.bytes)
                if set(counter.counts) != {"all-reduce"}:
                    raise RuntimeError(f"20(t) {name} rank {rank}: "
                                       f"collectives {counter.counts}: "
                                       f"all-reduces only on the card")
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = _tp_kernel_counts(ops, fa, scan)
        sides[dev] = got
    worst = {}
    for key in sides["cuda"]:
        name = key.rsplit(" ", 1)[0]
        if key.endswith("train"):
            view = {dev: {"train": sides[dev][key]} for dev in sides}
            worst[key] = _tp_hold_rounds(
                torch, f"20(t) {key} rank {rank}", "train", view,
                tfm.init_params(torch.Generator().manual_seed(0),
                                cfgs[name]), cfgs[name], meshes["cpu"])
            continue
        (heads_a, cache_a), (heads_b, cache_b) = (sides["cuda"][key],
                                                  sides["cpu"][key])
        _tp_allclose(torch, f"20(t) {key} rank {rank} cache", cache_a,
                     cache_b)
        _tp_allclose(torch, f"20(t) {key} rank {rank} logits", heads_a,
                     heads_b)
        worst[key] = max(float((x - y).abs().max()) for x, y in zip(
            heads_a + cache_a, heads_b + cache_b))
    # K5 f32 once an attention layer of each prefill (whole sequences)
    want = (0, 0, 0, 0, 0, sum(_mixer_counts(c)[0] for c in cfgs.values()),
            0)
    if launched != want:
        raise RuntimeError(f"20(t) rank {rank}: launches K1/K2/K3/K4/K5 tc/"
                           f"K5 f32/K6 {launched}, expected {want}")
    print(f"  (t) rank {rank}: the (2, 1) mesh, card against CPU: reduced "
          f"qwen2-moe's prefill and serve steps (decode's group over data) "
          f"and reduced kimi-k2's train step, prefill and serve steps (its "
          f"2-D experts {placements}), worst {worst}; collectives (counts, "
          f"bytes) {collectives}; launches {launched}", flush=True)
    return {"launches": launched, "worst": worst,
            "collectives": collectives, "placements": placements}


# phase 20(q): the two ranks as a (2, 1, 1) ("pod", "data", "model") mesh
#  running (n)'s narrow rounds (reduced gemma2-2b, f32, K = 2, one simple,
#  2 local steps): each pod rank folds its client, the fold all-reduced
#  over the pod x data group
TP_POD_ENGINES = ("f32", "int8", "tree")


def tp_pod_rounds(torch, rank: int) -> dict:
    """Phase 20(q) on one rank: the rounds of ``TP_POD_ENGINES`` over the
    card's (2, 1, 1) pod mesh, bitwise the same rounds over the card's
    (2, 1) ("data", "model") mesh (a pod of 2 over data of 1 is a
    relabelling) and held to the CPU's (2, 1, 1) mesh at rtol 1e-4 / atol
    1e-5 (the int8 round under ``repro_torch.parity``'s rules).  K1, K2
    and K4 counted on the card's pod runs: one fold of this rank's client
    a round."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import aggregate, comm
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map
    engines = {"f32": None,
               "int8": aggregate.EngineSpec(wire=comm.WireSpec("int8", QB)),
               "tree": aggregate.EngineSpec(engine="tree")}
    meshes = {"pod cuda": make_device_mesh(1, 1, "cuda", n_pod=TP_RANKS),
              "data cuda": make_device_mesh(TP_RANKS, 1, "cuda"),
              "pod cpu": make_device_mesh(1, 1, "cpu", n_pod=TP_RANKS)}
    cfg = configs.get_reduced(STEP_ARCH)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(7)
    data = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        2, 2, 2, 17)).astype(np.int32))
    simple = torch.tensor([True, False])
    sides = {}
    for name, mesh in meshes.items():
        dev = name.split()[-1]
        policy = sharding.MeshPolicy(mesh, cfg)
        _tp_zero(ops, fa, scan)
        got = {}
        for e in TP_POD_ENGINES:
            cohort = tree_map(lambda x: x.to(dev)[None].expand(
                (2,) + x.shape), params)
            new_c, loss = steps.make_fed_round_step(
                cfg, policy, local_steps=2, engine=engines[e])(
                    cohort, data.to(dev), simple.to(dev))
            got[e] = ([x.cpu() for x in tree_leaves(new_c)], loss.cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            got["launches"] = _tp_kernel_counts(ops, fa, scan)
        sides[name] = got
    want = (1, 1, 0, 1, 0, 0, 0)
    if sides["pod cuda"]["launches"] != want:
        raise RuntimeError(f"20(q) rank {rank}: launches K1/K2/K3/K4/K5 "
                           f"tc/K5 f32/K6 {sides['pod cuda']['launches']}, "
                           f"expected {want}")
    worst = {}
    for e in TP_POD_ENGINES:
        (a, la), (b, lb) = sides["pod cuda"][e], sides["data cuda"][e]
        if not (torch.equal(la, lb) and all(
                torch.equal(x, y) for x, y in zip(a, b))):
            raise RuntimeError(f"20(q) rank {rank}: the {e} round over the "
                               f"pod mesh is not the data mesh's bitwise")
        wire = "int8" if e == "int8" else "f32"
        worst[e] = _tp_hold_rounds(
            torch, f"20(q) {e} rank {rank}", wire,
            {"cuda": {wire: sides["pod cuda"][e]},
             "cpu": {wire: sides["pod cpu"][e]}}, params, cfg,
            meshes["pod cpu"])
    print(f"  (q) rank {rank}: reduced gemma2-2b's rounds {TP_POD_ENGINES} "
          f"over a (2, 1, 1) pod mesh bitwise the (2, 1) data mesh's, card "
          f"against CPU worst {worst}; launches "
          f"{sides['pod cuda']['launches']}", flush=True)
    return {"launches": sides["pod cuda"]["launches"], "worst": worst}


def tp_rank(rank: int, world: int, store: str, work: str,
            parts: tuple = TP_PARTS) -> None:
    """One rank of phase 20 (spawned by :func:`tp_phase`): gloo over a
    FileStore, the (1, 2) meshes on the card and on the CPU, then (a)-(e)
    (``"dense"`` in ``parts``), (f)-(h) (``"moe"``), (i)-(k)
    (``"xlstm_codebooks"``), (l)-(n) (``"seq2d"``), (o)-(q)
    (``"hybrid_audio"``), (r)-(t) (``"moe_split"``) and (u)-(v)
    (``"ssm_split"``); writes
    ``rank<r>.pt`` (or the traceback to ``rank<r>.err``, and raises)."""
    import faulthandler
    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_device_mesh
    faulthandler.enable()       # a crash in a rank prints where it was
    try:
        resolve_device("cuda")
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                store=dist.FileStore(store, world))
        meshes = {"cuda": make_device_mesh(1, world, "cuda"),
                  "cpu": make_device_mesh(1, world, "cpu")}
        out = {"seconds": {}}

        def cell(key, fn, *args):
            t = time.perf_counter()
            out[key] = fn(torch, rank, *args)
            out["seconds"][key] = time.perf_counter() - t
        cuda = meshes["cuda"]
        if "dense" in parts:
            cell("round", tp_round, work, cuda)
            cell("prefill", tp_serving, cuda)
            cell("narrow", tp_card_vs_cpu, meshes)
        if "moe" in parts:
            cell("moe", tp_moe_serving, world, cuda)
            cell("moe_narrow", tp_moe_card_vs_cpu, meshes)
        if "xlstm_codebooks" in parts:
            cell("zoo", tp_zoo_serving, cuda)
            cell("zoo_narrow", tp_zoo_card_vs_cpu, meshes)
        if "seq2d" in parts:
            cell("split", tp_split_serving, cuda)
            cell("split_narrow", tp_split_card_vs_cpu, meshes)
        if "hybrid_audio" in parts:
            cell("hybrid", tp_split_serving, cuda, TP_HYBRID_RUNS)
            cell("hybrid_narrow", tp_split_card_vs_cpu, meshes,
                 TP_HYBRID_NARROW, "p")
            cell("pod", tp_pod_rounds)
        if "moe_split" in parts:
            cell("moe_split", tp_moe_serving, world, cuda, TP_MOE_SPLIT_RUNS)
            cell("moe_split_narrow", tp_split_card_vs_cpu, meshes,
                 TP_MOE_SPLIT_NARROW, "s")
            cell("moe_group", tp_moe_group_card_vs_cpu)
        if "ssm_split" in parts:
            cell("ssm", tp_split_serving, cuda, TP_SSM_RUNS)
            cell("ssm_narrow", tp_split_card_vs_cpu, meshes, TP_SSM_NARROW,
                 "v")
        print(f"  phase 20 rank {rank}: each cell's seconds "
              f"{ {k: round(v, 1) for k, v in out['seconds'].items()} }",
              flush=True)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            import traceback
            f.write(traceback.format_exc())
        raise


def _tp_local_layout(torch, cfg):
    """Rank 0's local layout and flat mask of ``cfg`` at the (1, 2) mesh:
    each leaf at its shard's shape (``param_specs``; empty CPU tensors,
    nothing written)."""
    from repro_torch.core import flatten, masking
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    mesh = MeshShape((1, TP_RANKS), ("data", "model"))
    params = tfm.abstract_params(cfg)

    def local(x, spec):
        shape = list(x.shape)
        for d, entry in enumerate(spec):
            if entry == "model":
                shape[d] = sharding.shard_rows(shape[d], 0, TP_RANKS)[1]
        return torch.empty(shape, dtype=x.dtype)
    tree = tree_map(local, params, sharding.param_specs(params, cfg, mesh))
    layout = flatten.layout_of(tree, total_multiple=2048)
    return layout, flatten.pack_mask(
        layout, masking.transformer_subnet_mask(tree, cfg), "cuda")


def tp_phase(torch, ops, ref, bw: float, unsharded,
             parts: tuple = TP_PARTS) -> dict:
    """Phase 20: the model axis on the card.  Phase 18(a)'s unsharded
    rounds are saved for the ranks, the card's memory is released, two
    rank processes run (a)-(e), the MoE cells (f)-(h), the xLSTM and
    codebook cells (i)-(k), the token splits (l)-(q), the MoE token
    splits (r)-(t) and the xLSTM token splits (u)-(v) (:func:`tp_rank`;
    each raises on a failed check, and a rank's failure fails the phase),
    then K1 and K2 at the rank's local n_flat, K5 at a rank's heads and on
    a rank's query rows (:func:`check_flash_rows`) and K6's gated entry at
    a rank's channels are held to their plain versions and timed here, the
    card to themselves.  ``parts`` (``TP_PARTS``) picks the cells; without
    ``"dense"`` ``unsharded`` is not read and only K5 is timed, at the
    shapes of the parts run."""
    import torch.multiprocessing as mp
    from repro_torch import configs
    from repro_torch.kernels import build
    t = time.perf_counter()
    build.build()      # the ranks load the built library, never build it
    work = tempfile.mkdtemp(prefix="tp_phase_")
    try:
        _free_disk_check(work, 12e9)
        for wire, (tree, loss) in (unsharded or {}).items():
            torch.save((tree, loss), os.path.join(work, f"{wire}.pt"))
        saved = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=tp_rank, args=(
            r, TP_RANKS, os.path.join(work, "store"), work, parts))
            for r in range(TP_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(TP_JOIN_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        errors = [open(os.path.join(work, f"rank{r}.err")).read()
                  for r in range(TP_RANKS)
                  if os.path.exists(os.path.join(work, f"rank{r}.err"))]
        if hung or errors or any(p.exitcode for p in procs):
            raise RuntimeError(f"phase 20: {len(hung)} rank(s) hung past "
                               f"{TP_JOIN_S} s, exit codes "
                               f"{[p.exitcode for p in procs]}, errors "
                               f"{errors}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
                 for r in range(TP_RANKS)]
        ranks_s = time.perf_counter() - t - saved
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"ranks": ranks, "saved_s": saved, "ranks_s": ranks_s}
    print(f"  phase 18(a)'s rounds saved in {saved:.1f} s; the two ranks "
          f"in {ranks_s:.1f} s", flush=True)
    out["k5"] = check_flash(torch, bw, [
        c for c, part in zip(TP_FLASH_CASES, TP_FLASH_PARTS)
        if part in parts])
    if {"seq2d", "hybrid_audio", "moe_split"} & set(parts):
        out["k5_rows"] = check_flash_rows(torch, bw)
    if "hybrid_audio" in parts:
        out["k6_carry"] = check_scan_carry(torch, bw)
    if "dense" not in parts:
        return out
    launches = [r["round"]["runs"][0]["launches"][0]
                + r["round"]["runs"][1]["launches"][1] for r in ranks]
    # the kernels at the shapes a rank hands them, the card to themselves
    layout, mask = _tp_local_layout(torch, configs.get_config(STEP_ARCH))
    print(f"  a rank's local layout: n_flat {layout.n_flat:,}, |M| "
          f"{count_true(mask):,} (ranks: "
          f"{[r['round']['local_params'] for r in ranks]} params)",
          flush=True)
    out["n_flat"] = layout.n_flat
    out["k2"] = check_deq_lm(torch, ops, ref, bw, mask)
    out["k1"] = check_folds_lm(torch, ops, ref, bw, layout, mask,
                               keys=("k1",))["k1"]
    del mask
    torch.cuda.empty_cache()
    out["k6"] = check_scan(torch, bw, (), TP_GATED_CASES)

    def split_narrow(r):
        return [c for key in ("split_narrow", "hybrid_narrow",
                              "moe_split_narrow", "ssm_narrow")
                for c in r.get(key, {}).get("launches", {}).values()]

    def narrow(r, i):
        return sum(r[key]["launches"][i] for key in (
            "moe_narrow", "zoo_narrow", "pod", "moe_group")
            if key in r) + sum(c[0][i] for c in split_narrow(r))

    def split(r):
        return r.get("split", []) + r.get("hybrid", []) + r.get(
            "moe_split", []) + r.get("ssm", [])

    def rows(r, i):
        return sum(p["launches_rows"][i] for p in split(r)) + sum(
            c[1][i] for c in split_narrow(r))

    def moe_rows(r):
        return sum(p["launches_rows"][0] for p in r.get("moe_split", []))
    out["launches"] = {
        "k1": sum(r["round"]["runs"][0]["launches"][0] + narrow(r, 0)
                  for r in ranks),
        "k2": sum(r["round"]["runs"][1]["launches"][1] + narrow(r, 1)
                  for r in ranks),
        "k4": sum(r["narrow"]["launches"][3] + narrow(r, 3) for r in ranks),
        "k5_tc": sum(p["launches"][0] for r in ranks
                     for p in r["prefill"] + r.get("moe", [])
                     + r.get("zoo", []) + split(r)),
        "k5_f32": sum(r["narrow"]["launches"][5] + narrow(r, 5)
                      for r in ranks),
        # (r)'s rank-1 rows have a row of their own, at their shape
        "k5_tc_rows": sum(rows(r, 0) - moe_rows(r) for r in ranks),
        "k5_tc_rows_moe": sum(moe_rows(r) for r in ranks),
        "k5_f32_rows": sum(rows(r, 1) for r in ranks),
        "k6": sum(p["launches"][2] for r in ranks
                  for p in r["prefill"] + split(r)) + sum(
                      narrow(r, 6) for r in ranks),
        "k6_carry": sum(p["launches_carry"] for r in ranks
                        for p in split(r)) + sum(
                            c[2] for r in ranks for c in split_narrow(r))}
    print(f"  phase 20 launches over both ranks {out['launches']} "
          f"({launches} K1 + K2 a rank) in {time.perf_counter() - t:.1f} s",
          flush=True)
    return out


def tp_phase_alone(torch, ops, ref, bw: float,
                   parts: tuple = TP_PARTS) -> dict:
    """Phase 20 run alone: phase 18(a)'s two unsharded rounds first (as
    phase 19 runs them when alone), then :func:`tp_phase`; with ``parts``
    ``("moe",)`` the MoE cells (f)-(h) alone, with
    ``("xlstm_codebooks",)`` the cells (i)-(k) alone, with ``("seq2d",)``
    the token splits (l)-(n) and K5 on a rank's query rows alone, with
    ``("moe_split",)`` the MoE token splits (r)-(t) and K5 on a rank's
    query rows alone, and with ``("ssm_split",)`` the xLSTM token splits
    (u)-(v) alone, without those rounds."""
    if "dense" not in parts:
        return tp_phase(torch, ops, ref, bw, None, parts)
    from repro_torch import configs
    from repro_torch.core import flatten, masking
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.tree import tree_map
    cfg = configs.get_config(STEP_ARCH)
    params = LMAdapter(cfg).init(torch.Generator("cuda").manual_seed(0),
                                 "cuda")
    layout = flatten.layout_of(params, total_multiple=2048)
    flat_mask = flatten.pack_mask(
        layout, masking.transformer_subnet_mask(params, cfg), "cuda")
    cohort = tree_map(lambda x: x[None].expand((STEP_K,) + x.shape), params)
    unsharded = _unsharded_rounds(torch, cfg, cohort, _step_tokens(torch),
                                  torch.tensor(STEP_SIMPLE, device="cuda"),
                                  flat_mask)
    del params, cohort, flat_mask
    gc.collect()
    torch.cuda.empty_cache()
    return tp_phase(torch, ops, ref, bw, unsharded)


class PhaseClock:
    """The smoke's phase headers with their times: :meth:`start` prints a
    phase's ``[N] title`` header with the smoke's seconds so far, after
    the line that closes the phase before (its seconds); ``seconds``
    keeps each phase's, so a run that stretches shows which phase did."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.current, self.seconds = None, {}

    def stop(self) -> None:
        if self.current is not None:
            n, t = self.current
            self.seconds[n] = round(time.perf_counter() - t, 1)
            print(f"  [{n}] {self.seconds[n]:.1f} s", flush=True)
            self.current = None

    def start(self, header: str) -> None:
        self.stop()
        now = time.perf_counter()
        print(f"{header} (at {now - self.t0:.1f} s)", flush=True)
        self.current = (header[1:header.index("]")], now)


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
    clock = PhaseClock()
    # 1. card report
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name_of_card = torch.cuda.get_device_name(0)
    bw, part = memory_rate(name_of_card)
    clock.start("[1] card")
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name_of_card}; bounds at {part} HBM {bw / 1e12:.2f} TB/s",
          flush=True)
    # 2. build
    clock.start("[2] build")
    t = time.perf_counter()
    res = build.build()
    print(f"  {res.path.name} in {res.seconds:.1f} s", flush=True)
    for ln in res.log.splitlines():
        if ln.startswith("==") or "registers" in ln or "spill" in ln:
            print("  " + ln.strip(), flush=True)
    print(f"  build total {time.perf_counter() - t:.1f} s", flush=True)
    # 3. the kernels against their plain versions
    clock.start("[3] kernels vs plain PyTorch on the card")
    k1 = check_masked_agg(torch, ops, ref, bw)
    mask = main_path_layout(torch)[1]
    k2 = check_deq(torch, ops, ref, bw, mask)
    k3 = check_scatter(torch, ops, ref, bw, mask)
    k4 = check_tree_fold(torch, ops, ref, bw)
    # 4. main path
    clock.start("[4] main path: full-width PreActResNet18-GN rounds")
    path = main_path(torch, ops)
    # 5. card vs CPU
    clock.start("[5] card vs CPU")
    card_vs_cpu(torch)
    # 6. the serving kernels
    clock.start("[6] serving kernels vs plain PyTorch on the card")
    k5 = check_flash(torch, bw)
    k6 = check_scan(torch, bw)
    # 7. full-width serving
    clock.start("[7] full-width serving: recurrentgemma-2b and gemma2-2b")
    serve_path = serving(torch)
    # 8. narrow serving, card vs CPU, decode vs prefill
    clock.start("[8] narrow serving: card vs CPU, decode vs prefill")
    narrow = serving_card_vs_cpu(torch)
    xlstm_serving_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    # 9. the full-width LM round cell
    clock.start("[9] LM round cell: Gemma-2 2B federated training at full "
                "width")
    lm = lm_cell(torch, ops, ref, bw)
    # 10. narrow LM rounds, card vs CPU
    clock.start("[10] narrow LM rounds: card vs CPU")
    lm_card_vs_cpu(torch)
    xlstm_round_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    # 11. async rounds
    clock.start("[11] async rounds: the ResNet and LM cells, narrow card vs "
                "CPU")
    async_launches, resnet_tr, resnet_shards = async_resnet(torch, ops)
    lm_k1, lm_tr, _ = async_lm(torch, ops)
    async_launches = (async_launches[0] + lm_k1,) + async_launches[1:]
    if not all(async_launches):
        raise RuntimeError(f"async path launches K1/K2/K3/K4 "
                           f"{async_launches}: a kernel never ran")
    async_card_vs_cpu(torch)
    # 12. checkpoints
    clock.start("[12] checkpoints: the LM and ResNet cells, narrow resume, "
                "serving from a checkpoint")
    checkpoint_lm(torch, lm_tr)
    del lm_tr
    torch.cuda.empty_cache()
    checkpoint_resnet(torch, resnet_tr, resnet_shards)
    del resnet_tr, resnet_shards
    resume_card(torch)
    serve_launches = serve_checkpoint(torch)
    torch.cuda.empty_cache()
    # 13. telemetry
    clock.start("[13] telemetry: determinism, null sink, run logs, Gemma-2 "
                "2B trained and served, overhead")
    tel_launches, tel_k5, _ = telemetry_phase(torch, ops)
    gc.collect()
    torch.cuda.empty_cache()
    # 14. full-width serving of the dense configs
    clock.start("[14] full-width serving: gemma3-4b, minitron-8b, "
                "starcoder2-15b")
    dense_path = serving(torch, DENSE_SERVE_RUNS)
    torch.cuda.empty_cache()
    # 15. full-width serving of the MoE configs
    clock.start("[15] full-width serving: qwen2-moe-a2.7b, kimi-k2-1t-a32b "
                "at published widths (depth 1)")
    moe_path = serving(torch, MOE_SERVE_RUNS)
    del moe_path["runs"]
    gc.collect()
    torch.cuda.empty_cache()
    # 16. xLSTM at full width
    clock.start("[16] xlstm-1.3b at full width: served whole, one fedhen "
                "round")
    xl = xlstm_phase(torch, ops, ref, bw)
    gc.collect()
    torch.cuda.empty_cache()
    # 17. llava-next-34b and musicgen-large
    clock.start("[17] llava-next-34b and musicgen-large at full width: "
                "served whole, musicgen-large trained; narrow card vs CPU")
    zoo = zoo_phase(torch, ops, ref, bw)
    gc.collect()
    torch.cuda.empty_cache()
    # 18. the launch-side step functions, gemma3-4b trained, the quickstart
    clock.start("[18] launch-side steps: Gemma-2 2B step rounds at full "
                "width, narrow steps card vs CPU, make_engine, gemma3-4b "
                "trained at full width, the quickstart")
    st = steps_phase(torch, ops, ref, bw)
    unsharded = st["round"].pop("results")
    gc.collect()
    torch.cuda.empty_cache()
    # 19. the cohort-sharded round, chunk2d attention, the roofline ledger
    clock.start("[19] cohort-sharded step rounds over torch.distributed "
                "(NCCL and gloo, world size 1), chunk2d attention, the "
                "roofline ledger")
    sh = sharded_phase(torch, ops, unsharded)
    gc.collect()
    torch.cuda.empty_cache()
    # 20. a live model axis: two ranks share the card over gloo
    clock.start("[20] a live model axis: Gemma-2 2B's step rounds, "
                "minitron-8b, recurrentgemma-2b, gemma2-2b, qwen2-moe-a2.7b, "
                "kimi-k2 (1 layer), xlstm-1.3b and musicgen-large prefilled "
                "and served on sharded caches at full width, gemma2-2b under "
                "seq2d and dp2d, recurrentgemma-2b, qwen2-moe-a2.7b and "
                "xlstm-1.3b under seq2d, two ranks sharing the card (gloo, a "
                "(1, 2) mesh); narrow card vs CPU (dense, MoE, xLSTM and "
                "codebooks, the token splits of every arch type); the narrow "
                "rounds over a (2, 1, 1) pod mesh")
    tp = tp_phase(torch, ops, ref, bw, unsharded)
    del unsharded

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
    head = xl["round"]["k1"]["timing"][0]     # the complex client's fold
    kernels[0]["launches_xlstm"] = xl["round"]["launches"]
    kernels[0]["launches_xlstm_path"] = ("phase 16: two fedhen rounds of "
                                         "xlstm-1.3b at full width")
    kernels[0]["xlstm"] = {
        "shape": {"Z": 1, "N": xl["round"]["k1"]["N"], "x": "float32",
                  "fold": "complex", "mask": "xlstm-1.3b index set M"},
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_share": head["bound_share"], "max_abs_err": 0.0,
        "folds": xl["round"]["k1"]["timing"]}
    head = zoo["round"]["k1"]["timing"][0]    # the complex client's fold
    kernels[0]["launches_musicgen"] = zoo["round"]["launches"]
    kernels[0]["launches_musicgen_path"] = ("phase 17: two fedhen rounds of "
                                            "musicgen-large at full width")
    kernels[0]["musicgen"] = {
        "shape": {"Z": 1, "N": zoo["round"]["k1"]["N"], "x": "float32",
                  "fold": "complex", "mask": "musicgen-large index set M"},
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_share": head["bound_share"], "max_abs_err": 0.0,
        "folds": zoo["round"]["k1"]["timing"]}
    # phase 18: (a) the full-width step rounds (K1 on the f32 wire, K2 on
    # the int8 wire), (b) the narrow step cases' card runs, (d) gemma3-4b's
    # rounds, (e) the quickstart
    for i, j in ((0, 0), (1, 1), (3, 2)):     # K1, K2, K4
        kernels[i]["launches_steps_narrow"] = st["narrow"]["launches"][j]
        kernels[i]["launches_steps_narrow_path"] = (
            "phase 18(b): the narrow make_fed_round_step cases on the card")
    for i in (0, 1):
        kernels[i]["launches_steps"] = st["round"]["launches"][i]
        kernels[i]["launches_steps_path"] = (
            "phase 18(a): make_fed_round_step on Gemma-2 2B at full width, "
            "f32 and int8 wires")
    head = st["round"]["k2"]["timing"][0]     # the complex client's fold
    kernels[1]["steps"] = {
        "shape": {"Z": 1, "N": st["round"]["k2"]["N"], "q": "int8",
                  "quant_block": QB, "fold": "complex",
                  "mask": "gemma2-2b index set M"},
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_share": head["bound_share"], "max_abs_err": 0.0,
        "folds": st["round"]["k2"]["timing"]}
    head = st["gemma3"]["k1"]["timing"][0]    # the complex client's fold
    kernels[0]["launches_gemma3"] = st["gemma3"]["launches"]
    kernels[0]["launches_gemma3_path"] = ("phase 18(d): two fedhen rounds "
                                          "of gemma3-4b at full width")
    kernels[0]["gemma3"] = {
        "shape": {"Z": 1, "N": st["gemma3"]["k1"]["N"], "x": "float32",
                  "fold": "complex", "mask": "gemma3-4b index set M"},
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_share": head["bound_share"], "max_abs_err": 0.0,
        "folds": st["gemma3"]["k1"]["timing"]}
    kernels[0]["launches_quickstart"] = st["quickstart"]["launches"]
    kernels[0]["launches_quickstart_path"] = (
        "phase 18(e): examples/quickstart_torch.py, 3 x 36 rounds")
    # phase 19: (a) the sharded full-width step rounds, (b) the narrow
    # sharded steps' card runs, (d) the telemetry-on LM round
    for i in (0, 1):
        kernels[i]["launches_sharded"] = sh["round"]["launches"][i]
        kernels[i]["launches_sharded_path"] = (
            "phase 19(a): make_fed_round_step under a MeshPolicy over a live "
            "(1, 1) DeviceMesh (NCCL), Gemma-2 2B at full width, f32 and "
            "int8 wires")
    for i in (0, 3):
        kernels[i]["launches_sharded_narrow"] = sh["narrow"]["launches"][i]
        kernels[i]["launches_sharded_narrow_path"] = (
            "phase 19(b): the narrow sharded steps (flat, tree) on the card")
    kernels[0]["launches_roofline"] = sh["roofline"]["launches"][0]
    kernels[0]["launches_roofline_path"] = (
        "phase 19(d): one LM-cell round with telemetry on (the roofline "
        "walk)")
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
    kernels[-2]["launches_llava"] = zoo["serve"]["llava"]["launches"][0]
    kernels[-2]["launches_llava_path"] = ("phase 17: llava-next-34b served "
                                          "whole, text-only generate")
    kernels[-2]["launches_llava_frontend"] = (
        zoo["serve"]["llava"]["frontend"]["frontend_launches"][0])
    kernels[-2]["launches_llava_frontend_path"] = (
        "phase 17: llava-next-34b's two prefills with 2880 patch rows, then "
        "7 decode steps")
    kernels[-2]["launches_musicgen"] = (
        zoo["serve"]["musicgen"]["launches"][0])
    kernels[-2]["launches_musicgen_path"] = ("phase 17: musicgen-large "
                                             "served whole")
    for kernel, launches in zip(kernels[-2:], (
            zoo["narrow"]["bfloat16"][0], zoo["narrow"]["float32"][1])):
        kernel["launches_zoo_narrow"] = launches
        kernel["launches_zoo_narrow_path"] = (
            "phase 17: reduced llava-next-34b and musicgen-large served on "
            "the card against the CPU")
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
    # phase 20: each kernel's launches on both ranks' local shards, and its
    # time at the shape a rank hands it
    by_name = {k["name"]: k for k in kernels}
    tp_path = ("phase 20: two ranks sharing the card over gloo, a (1, 2) "
               "mesh: ")
    for name, key, path, row in (
            ("masked_agg_acc", "k1", "(a) Gemma-2 2B's f32 step round at "
             "full width, (h) reduced qwen2-moe's f32 round, (k) reduced "
             "xlstm-1.3b's and musicgen-large's f32 rounds, (n) reduced "
             "gemma2-2b's f32 and SCAFFOLD rounds under seq2d and dp2d",
             tp["k1"]["timing"][0]),
            ("masked_agg_acc_deq", "k2", "(a) Gemma-2 2B's int8 step round "
             "at full width, (h) reduced qwen2-moe's int8 round, (k) "
             "reduced xlstm-1.3b's and musicgen-large's int8 rounds, (n) "
             "reduced gemma2-2b's int8 and int8 top-k rounds under seq2d "
             "and dp2d",
             tp["k2"]["timing"][0]),
            ("masked_agg", "k4", "(d) the narrow tree round on the card, "
             "(n) the token splits' narrow tree rounds", None),
            ("flash_attention_wgmma", "k5_tc", "(b) minitron-8b on 16 of 32 "
             "heads, (c) recurrentgemma-2b and (e) gemma2-2b replicated, "
             "(f) qwen2-moe-a2.7b on 8 of 16 heads, (g) kimi-k2-1t-a32b "
             "(1 layer) on 32 of 64, (j) musicgen-large on 16 of 32, each "
             "prefill then served on its sharded cache; (l) gemma2-2b under "
             "seq2d on rank 0's query rows, (m) under dp2d on a rank's "
             "sequence", tp["k5"]["timing"][0]),
            ("flash_attention", "k5_f32", "(d) the narrow f32 prefill on "
             "the card, (k) reduced musicgen-large's f32 prefill on 2 of 4 "
             "heads, (n) the token splits' narrow prefills (rank 0's rows, "
             "dp2d's sequences)", None),
            ("lru_scan", "k6", "(c) recurrentgemma-2b on 1280 of 2560 "
             "channels", tp["k6"]["timing"][0])):
        kernel = by_name[name]
        kernel["launches_tp"] = tp["launches"][key]
        kernel["launches_tp_path"] = tp_path + path
        if key == "k5_tc":
            kernel["tp_cases"] = [{k: r[k] for k in (
                "case", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_share", "library_ms") if k in r}
                for r in tp["k5"]["timing"]]
        if row is not None:
            kernel["tp"] = {k: row[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_share", "library_ms") if k in row}
            if key in ("k1", "k2"):
                kernel["tp"]["shape"] = {"Z": 1, "N": tp["n_flat"],
                                         "fold": "complex", "mask":
                                         "gemma2-2b M, a rank's shards"}
    # K5's query-offset entry: the same kernels on a rank's query rows past
    # the first (q_offset > 0), counted apart; timed at (l)'s rank-1 shape
    # and (n)'s f32 one
    for name, source, dtype, key, path, case in (
            ("flash_attention_wgmma (query-offset entry)",
             "flash_attention_wgmma.cu", "bfloat16", "k5_tc_rows",
             "(l) gemma2-2b under seq2d: rank 1's 4096 query rows at "
             "q_offset 4096 against 8192 keys, a layer each; (o) "
             "recurrentgemma-2b's rank-1 rows",
             "gemma2-2b global, rank 1's rows"),
            ("flash_attention_wgmma (query-offset entry, qwen2-moe-a2.7b's "
             "rows)", "flash_attention_wgmma.cu", "bfloat16",
             "k5_tc_rows_moe", "(r) qwen2-moe-a2.7b under seq2d: rank 1's "
             "2048 query rows at q_offset 2048 against 4096 keys, a layer "
             "each", "qwen2-moe-a2.7b, rank 1's rows"),
            ("flash_attention (query-offset entry)", "flash_attention.cu",
             "float32", "k5_f32_rows", "(n) reduced gemma2-2b under seq2d "
             "and llava-next-34b under seq2d_fsdp, (p) and (s): rank 1's "
             "query rows, card against CPU",
             "reduced gemma2-2b in f32, rank 1's rows")):
        rows = [r for r in tp["k5_rows"]["timing"]
                if r["shape"]["dtype"] == dtype]
        head = next(r for r in rows if r["case"] == case)
        kernels.append({
            "name": name, "route": "cuda", "source": k5_src + source,
            "replaces": k5_replaces, "entry": "q_offset > 0",
            "launches": tp["launches"][key], "launches_path": tp_path + path,
            "max_abs_err": tp["k5_rows"]["max_abs_err"][dtype],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "bound_share": head["bound_share"], "tflops": head["tflops"],
            "cases": rows})
    # K6's carried entry (y0 in, y_last out): a rank's rows of a split
    # sequence, timed at (o)'s rank shape
    carry = tp["k6_carry"]["timing"][0]
    kernels.append({
        "name": "lru_scan (carried entry)", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:52",
        "entry": "lru_scan_gated with y0 and y_last",
        "launches": tp["launches"]["k6_carry"],
        "launches_path": tp_path + "(o) recurrentgemma-2b under seq2d, 18 "
        "RG-LRU layers on each rank's 2048 rows (rank 1 from rank 0's "
        "y_last), (p) reduced recurrentgemma-2b under seq2d, card against "
        "CPU", "max_abs_err": tp["k6_carry"]["max_abs_err"],
        "ms": carry["ms"], "plain_ms": carry["plain_ms"],
        "bound_ms": carry["bound_ms"], "bound_by": carry["bound_by"],
        "library_ms": carry["library_ms"],
        "library_note": "the unfused composition the carried entry "
        "replaces: rglru._gates, y0 folded in, K6's plain entry, the cast "
        "and the f32 last row", "shape": carry["shape"],
        "bound_share": carry["bound_share"]})
    clock.stop()
    print(f"phase seconds {json.dumps(clock.seconds)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name_of_card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

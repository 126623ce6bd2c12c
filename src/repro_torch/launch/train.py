"""Federated training entry point of the port (FedHeN / NoSide / Decouple).

Runs the paper's protocol end to end, on the card by default: the
ResNet/CIFAR setting on synthetic CIFAR-shaped data (``--model resnet``),
or a decoder LM of the zoo on ``synthetic_lm`` token streams
(``--model lm --arch NAME [--reduced]``; a multi-codebook arch such as
musicgen-large trains on one stream per codebook, and a frontend arch such
as llava-next-34b on text alone, as the reference's CLI runs them).
Takes every flag of ``repro.launch.train``, plus ``--device``, and
prints the reference CLI's lines: its prints route through a
``Telemetry`` with a stdout sink (and a JSONL sink with
``--telemetry-out``), and the trainer is instrumented only with
``--telemetry`` or ``--telemetry-out``.
The LM data's Markov chain draws from the model's first
:data:`DATA_VOCAB_CAP` token ids at most (its table is vocab x vocab f32:
262 GB at Gemma-2's 256,000).

Examples (on a machine with a CUDA card):
    PYTHONPATH=src python -m repro_torch.launch.train --model resnet \
        --algorithm fedhen --rounds 20 --clients 100 --participation 0.1 \
        --data-points 50000 --local-epochs 1 --eval-every 5
    # the compressed wire: int8 + top-k 1/14 + stochastic rounding + EF
    PYTHONPATH=src python -m repro_torch.launch.train --model resnet \
        --rounds 20 --clients 100 --data-points 50000 --local-epochs 1 \
        --comm-dtype int8 --topk-frac 0.0714 --stochastic-rounding \
        --error-feedback
    # the tree engine (one K4 launch per fold), SCAFFOLD, uniform sampling
    PYTHONPATH=src python -m repro_torch.launch.train --model resnet \
        --rounds 20 --clients 100 --data-points 50000 --local-epochs 1 \
        --agg-engine tree --variance-reduction scaffold --sample-uniform
    # federated LM training at Gemma-2 2B's full width (bf16)
    PYTHONPATH=src python -m repro_torch.launch.train --model lm \
        --arch gemma2-2b --rounds 2 --clients 8 --participation 0.25 \
        --cohort-chunk 1 --local-epochs 1 --batch-size 2 --data-points 32 \
        --seq-len 512 --eval-every 1
    # a reduced LM on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --model lm \
        --arch gemma2-2b --reduced --device cpu --rounds 3 --clients 8 \
        --participation 0.5 --local-epochs 1 --batch-size 4 \
        --data-points 64 --seq-len 16 --eval-every 1
    # async rounds (lag 2) saved every round, then resumed to round 5
    PYTHONPATH=src python -m repro_torch.launch.train --model lm \
        --arch gemma2-2b --reduced --device cpu --rounds 3 --clients 8 \
        --participation 0.5 --local-epochs 1 --batch-size 4 \
        --data-points 64 --seq-len 16 --eval-every 1 --async-lag 2 \
        --checkpoint run.ckpt --checkpoint-every 1
    PYTHONPATH=src python -m repro_torch.launch.train ... --rounds 5 \
        --async-lag 2 --checkpoint run.ckpt --checkpoint-every 1 --resume
    # telemetry: the run's event stream as JSONL, then its report
    PYTHONPATH=src python -m repro_torch.launch.train --model resnet \
        --rounds 4 --clients 100 --data-points 50000 --local-epochs 1 \
        --eval-every 2 --telemetry-out run.jsonl
    PYTHONPATH=src python -m repro_torch.obs.report run.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import restore_trainer, save_trainer
from repro_torch.configs.base import FedConfig
from repro_torch.core.adapters import LMAdapter, ResNetAdapter
from repro_torch.core.federated import FederatedTrainer, rounds_to_target
from repro_torch.data import federated as fed_data
from repro_torch.data.synthetic import synthetic_cifar, synthetic_lm
from repro_torch.obs import telemetry as obslib

# synthetic_lm's transition table is (vocab, vocab) f32: the LM data draws
# from the first ids of the model's vocabulary, at most this many
DATA_VOCAB_CAP = 4096


def build_trainer(args, telemetry=None) -> tuple:
    fed = FedConfig(
        n_devices=args.clients, n_simple=args.clients // 2,
        participation=args.participation,
        sample_uniform=args.sample_uniform, rounds=args.rounds,
        local_epochs=args.local_epochs, lr=args.lr,
        batch_size=args.batch_size, iid=not args.non_iid,
        dirichlet_alpha=args.alpha, algorithm=args.algorithm,
        seed=args.seed, cohort_chunk=args.cohort_chunk,
        agg_engine=args.agg_engine, agg_block_n=args.agg_block_n,
        agg_stream_dtype=args.agg_stream_dtype,
        agg_memory_budget_mb=args.agg_memory_budget_mb,
        comm_dtype=args.comm_dtype, quant_block=args.quant_block,
        topk_frac=args.topk_frac,
        stochastic_rounding=args.stochastic_rounding,
        error_feedback=args.error_feedback,
        async_lag=args.async_lag, async_staleness=args.staleness,
        async_decay=args.staleness_decay,
        variance_reduction=args.variance_reduction,
        state_store_backend=args.state_store_backend)
    if args.model == "resnet":
        data = synthetic_cifar(args.data_points, 10, seed=args.seed)
        test_batch = synthetic_cifar(512, 10, seed=args.seed + 999)
        adapter = ResNetAdapter(10)
    else:
        cfg = (configs.get_reduced(args.arch) if args.reduced
               else configs.get_config(args.arch))
        vocab = min(cfg.vocab_size, DATA_VOCAB_CAP)
        data = synthetic_lm(args.data_points, args.seq_len, vocab,
                            seed=args.seed, n_codebooks=cfg.n_codebooks)
        test = synthetic_lm(64, args.seq_len, vocab, seed=args.seed + 999,
                            n_codebooks=cfg.n_codebooks)
        test_batch = {"tokens": test["tokens"]}
        adapter = LMAdapter(cfg)
    split = (fed_data.iid_split if fed.iid else
             lambda d, n, seed: fed_data.dirichlet_split(
                 d, n, fed.dirichlet_alpha, seed))
    shards = split(data, fed.n_devices, args.seed + 1)
    # LM shards keep only their tokens (labels only steer the split)
    shards = [{k: v for k, v in s.items()
               if k != "labels" or args.model == "resnet"} for s in shards]
    trainer = FederatedTrainer(adapter, fed, shards, device=args.device,
                               telemetry=telemetry)
    return trainer, test_batch


def _chunk_arg(v: str):
    return v if v == "auto" else int(v)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("resnet", "lm"), default="resnet")
    ap.add_argument("--arch", default="gemma2-2b",
                    help=f"the LM's architecture (one of "
                         f"{', '.join(configs.ARCH_NAMES)})")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced variant of --arch (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "(every kernel's plain PyTorch version)")
    ap.add_argument("--algorithm", default="fedhen",
                    choices=("fedhen", "noside", "decouple"))
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--participation", type=float, default=0.1)
    ap.add_argument("--sample-uniform", action="store_true",
                    help="the paper's uniform cohort sampling: one draw of "
                         "ceil(participation*clients) over the whole "
                         "population, routed into per-architecture slots "
                         "(unfilled slots fold at weight 0); default is the "
                         "stratified per-architecture approximation")
    ap.add_argument("--cohort-chunk", type=_chunk_arg, default=0,
                    help="fold the cohort in chunks of this many clients "
                         "(0 = whole population; 'auto' = derive from "
                         "--agg-memory-budget-mb)")
    ap.add_argument("--agg-engine", choices=("flat", "tree"), default="flat",
                    help="the fold: one masked-fold launch over the packed "
                         "model (flat) or one launch over a table of its "
                         "leaves into per-leaf sums (tree)")
    ap.add_argument("--agg-block-n", type=int, default=2048,
                    help="rounds the flat layout's length (multiple of 128)")
    ap.add_argument("--agg-stream-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="dtype trained chunks stream through the fold in "
                         "(accumulation is always f32)")
    ap.add_argument("--agg-memory-budget-mb", type=float, default=512.0,
                    help="memory budget targeted by --cohort-chunk auto")
    ap.add_argument("--comm-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"),
                    help="wire format: clients train on the decoded "
                         "broadcast and uploads are folded through it (int8 "
                         "= symmetric per-group quantization with f32 "
                         "scales, dequantized inside the fold)")
    ap.add_argument("--quant-block", type=int, default=128,
                    help="int8 wire scale-group size (elements per f32 "
                         "scale; must divide 128)")
    ap.add_argument("--topk-frac", type=float, default=1.0,
                    help="upload only the top-k largest-|x| entries of each "
                         "client's delta against its broadcast (k = frac * "
                         "element count, rounded up to a multiple of 128); "
                         "1.0 = dense uploads")
    ap.add_argument("--stochastic-rounding", action="store_true",
                    help="unbiased stochastic rounding of lossy upload "
                         "encodes (int8/bf16), seeded per client per round; "
                         "broadcasts stay round-to-nearest")
    ap.add_argument("--error-feedback", action="store_true",
                    help="keep each client's upload compression error in a "
                         "flat state-store row and add it to its next "
                         "upload; needs a lossy upload (bf16/int8 wire or "
                         "--topk-frac < 1)")
    ap.add_argument("--async-lag", type=int, default=0,
                    help="bounded broadcast staleness in chunk folds: "
                         "chunk t of a round trains on the server model "
                         "published at fold t - lag (the first lag chunks "
                         "overlap the previous round's fold); 0 = "
                         "synchronous")
    ap.add_argument("--staleness", default="poly", choices=("poly", "none"),
                    help="weighting of stale uploads: 'poly' = FedAsync "
                         "1/(1+s)^a decay, 'none' = full weight")
    ap.add_argument("--staleness-decay", type=float, default=0.5,
                    help="exponent a of the polynomial staleness decay "
                         "1/(1+s)^a")
    ap.add_argument("--variance-reduction", default="none",
                    choices=("none", "scaffold"),
                    help="'scaffold' keeps a control variate per client in "
                         "a flat state store and corrects local gradients "
                         "by c - c_i (option II); the cv exchange is billed "
                         "raw f32 on top of the wire")
    ap.add_argument("--state-store-backend", default="auto",
                    choices=("auto", "device", "host", "mmap"),
                    help="where the (clients, n_flat) error-feedback and "
                         "control-variate rows live; 'auto' picks by "
                         "footprint")
    ap.add_argument("--local-epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--data-points", type=int, default=4000)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--checkpoint", default="",
                    help="trainer checkpoint path (npz, written at exactly "
                         "this path)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the trainer every this many rounds")
    ap.add_argument("--checkpoint-format", default="tree",
                    choices=("tree", "flat"),
                    help="'flat' saves ONE packed buffer per model through "
                         "the wire encoder (int8 wires make it lossy, as "
                         "the broadcast is)")
    ap.add_argument("--resume", action="store_true",
                    help="restore --checkpoint (if it exists) and run the "
                         "rounds from its round counter to --rounds")
    ap.add_argument("--target-simple", type=float, default=0.0)
    ap.add_argument("--history-out", default="")
    ap.add_argument("--telemetry", action="store_true",
                    help="instrument the run with the repro_torch.obs "
                         "telemetry (round-phase spans, client-health "
                         "counters, comm ledgers); off by default")
    ap.add_argument("--telemetry-out", default="",
                    help="write the telemetry event stream as JSONL to "
                         "this path (implies --telemetry; render it with "
                         "python -m repro_torch.obs.report or "
                         "tools/obs_report.py)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    # the CLI's lines always route through a telemetry stdout sink (a
    # log event prints verbatim); the TRAINER is instrumented only when
    # asked, so the library default stays the disabled path
    instrument = args.telemetry or bool(args.telemetry_out)
    tel = obslib.Telemetry([obslib.StdoutSink()])
    if args.telemetry_out:
        tel.add_sink(obslib.JsonlSink(args.telemetry_out))
    say = tel.log

    trainer, test_batch = build_trainer(
        args, telemetry=tel if instrument else None)
    if args.cohort_chunk == "auto":
        per_mb = trainer.stream_bytes_per_client() / 2**20
        say(f"cohort_chunk=auto -> {trainer.cohort_chunk} "
            f"(per-client packed {per_mb:.2f} MiB at wire/stream dtype, "
            f"budget {args.agg_memory_budget_mb:.0f} MiB)")
    if args.async_lag:
        eng = trainer.async_engine
        steady = eng.schedule(10**9)
        say(f"async rounds: lag={eng.lag} folds/round="
            f"{eng.folds_per_round} versions={eng.n_versions} "
            f"staleness/chunk={list(map(int, steady[0]))} + "
            f"{list(map(int, steady[1]))} "
            f"(weights {args.staleness}, a={args.staleness_decay})")
    if args.comm_dtype != "float32" or trainer.wire.uses_deltas:
        say(f"comm wire {args.comm_dtype}: "
            f"{trainer.bytes_per_round / 1e6:.3f} MB/round measured "
            f"(down {trainer.bytes_down_per_round / 1e6:.3f} + up "
            f"{trainer.bytes_up_per_round / 1e6:.3f}; f32 analytic "
            f"{trainer.analytic_bytes_per_round() / 1e6:.3f})")
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        # the sampler is pure in (seed, round): restoring the round counter
        # resumes the cohort sequence an uninterrupted run draws
        restore_trainer(args.checkpoint, trainer,
                        fmt=args.checkpoint_format)
        say(f"resumed from round {trainer.server.round}")

    t0 = time.time()
    history = []
    for r in range(trainer.server.round, args.rounds):
        m = trainer.run_round()
        if args.eval_every and (r + 1) % args.eval_every == 0:
            ev = trainer.evaluate(test_batch)
            m.update(ev)
            if instrument:
                tel.set_round(r + 1)
                tel.ledger("eval", ev)
            say(f"[round {r + 1:4d}] " + "  ".join(
                f"{k}={v:.4f}" for k, v in sorted(m.items())))
        m["round"] = r + 1
        history.append(m)
        if args.checkpoint and args.checkpoint_every and \
                (r + 1) % args.checkpoint_every == 0:
            save_trainer(args.checkpoint, trainer,
                         fmt=args.checkpoint_format)

    dt = time.time() - t0
    say(f"\n{args.algorithm}: {args.rounds} rounds in {dt:.1f}s "
        f"({trainer.total_bytes / 1e6:.1f} MB communicated)")
    # the port's own lines (printed, not logged): the split and the device,
    # and the per-client stores' backends
    print(f"  {trainer.total_bytes_down / 1e6:.1f} MB down, "
          f"{trainer.total_bytes_up / 1e6:.1f} MB up, on {trainer.device}")
    for name, store in (("error-feedback", trainer.ef_store),
                        ("control-variate", trainer.cv_store)):
        if store is not None:
            print(f"{name} store: {store.backend} backend, "
                  f"{store.nbytes / 1e6:.1f} MB")
    if args.target_simple:
        r = rounds_to_target(history, "acc_simple", args.target_simple)
        say(f"rounds to simple acc {args.target_simple}: {r}")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    tel.close()
    if args.telemetry_out:
        print(f"telemetry run log: {args.telemetry_out} "
              f"(render: python tools/obs_report.py {args.telemetry_out})")
    return history


if __name__ == "__main__":
    main()

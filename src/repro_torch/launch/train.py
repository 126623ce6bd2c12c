"""Federated training entry point of the port (FedHeN / NoSide / Decouple).

Runs the paper's ResNet/CIFAR protocol end to end on synthetic
CIFAR-shaped data, on the card by default.  Takes the flags of
``repro.launch.train`` that the port supports so far, plus ``--device``;
argparse rejects every other flag.

Example (on a machine with a CUDA card):
    PYTHONPATH=src python -m repro_torch.launch.train --model resnet \
        --algorithm fedhen --rounds 20 --clients 100 --participation 0.1 \
        --data-points 50000 --local-epochs 1 --eval-every 5
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs.base import FedConfig
from repro_torch.core.adapters import ResNetAdapter
from repro_torch.core.federated import FederatedTrainer, rounds_to_target
from repro_torch.data import federated as fed_data
from repro_torch.data.synthetic import synthetic_cifar


def build_trainer(args) -> tuple:
    fed = FedConfig(
        n_devices=args.clients, n_simple=args.clients // 2,
        participation=args.participation, rounds=args.rounds,
        local_epochs=args.local_epochs, lr=args.lr,
        batch_size=args.batch_size, iid=not args.non_iid,
        dirichlet_alpha=args.alpha, algorithm=args.algorithm,
        seed=args.seed, cohort_chunk=args.cohort_chunk,
        agg_block_n=args.agg_block_n,
        agg_stream_dtype=args.agg_stream_dtype,
        agg_memory_budget_mb=args.agg_memory_budget_mb)
    data = synthetic_cifar(args.data_points, 10, seed=args.seed)
    test_batch = synthetic_cifar(512, 10, seed=args.seed + 999)
    split = (fed_data.iid_split if fed.iid else
             lambda d, n, seed: fed_data.dirichlet_split(
                 d, n, fed.dirichlet_alpha, seed))
    shards = split(data, fed.n_devices, args.seed + 1)
    trainer = FederatedTrainer(ResNetAdapter(10), fed, shards,
                               device=args.device)
    return trainer, test_batch


def _chunk_arg(v: str):
    return v if v == "auto" else int(v)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("resnet",), default="resnet",
                    help="the LM zoo is not ported yet")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "(every kernel's plain PyTorch version)")
    ap.add_argument("--algorithm", default="fedhen",
                    choices=("fedhen", "noside", "decouple"))
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--participation", type=float, default=0.1)
    ap.add_argument("--cohort-chunk", type=_chunk_arg, default=0,
                    help="fold the cohort in chunks of this many clients "
                         "(0 = whole population; 'auto' = derive from "
                         "--agg-memory-budget-mb)")
    ap.add_argument("--agg-block-n", type=int, default=2048,
                    help="rounds the flat layout's length (multiple of 128)")
    ap.add_argument("--agg-stream-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="dtype trained chunks stream through the fold in "
                         "(accumulation is always f32)")
    ap.add_argument("--agg-memory-budget-mb", type=float, default=512.0,
                    help="memory budget targeted by --cohort-chunk auto")
    ap.add_argument("--local-epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--data-points", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--target-simple", type=float, default=0.0)
    ap.add_argument("--history-out", default="")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    trainer, test_batch = build_trainer(args)
    t0 = time.time()
    history = trainer.run(args.rounds, eval_every=args.eval_every,
                          test_batch=test_batch,
                          log=lambda line: print(line, flush=True))
    dt = time.time() - t0
    print(f"\n{args.algorithm}: {args.rounds} rounds in {dt:.1f}s "
          f"({trainer.total_bytes / 1e6:.1f} MB communicated) on "
          f"{trainer.device}")
    if args.target_simple:
        r = rounds_to_target(history, "acc_simple", args.target_simple)
        print(f"rounds to simple acc {args.target_simple}: {r}")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()

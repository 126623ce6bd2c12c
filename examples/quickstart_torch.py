"""Quickstart on the PyTorch port: FedHeN vs NoSide vs Decouple on a tiny
federated LM.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: the same
model config, rounds, target, engine settings, data and shards, and the
same rounds-to-target table.  With the side objective (FedHeN), the
*simple* server model should reach the target accuracy in fewer
communication rounds than either baseline, because it trains on complex
devices' data too (Eq. 2).  Weights are drawn by PyTorch from the seed, so
the numbers are not the JAX run's.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device`` defaults to ``cuda`` (and raises without a card).  Add
``--telemetry-out run.jsonl`` to record the fedhen run's event stream and
render it with ``python -m repro_torch.obs.report run.jsonl``.
"""

import argparse

import torch

from repro_torch.configs.base import FedConfig, LayerSpec, ModelConfig
from repro_torch.core.adapters import LMAdapter
from repro_torch.core.federated import FederatedTrainer, rounds_to_target
from repro_torch.data.federated import iid_split
from repro_torch.data.synthetic import synthetic_lm
from repro_torch.obs import telemetry as obslib

CFG = ModelConfig(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=256, pattern=(LayerSpec("attn"),), exit_layer=2,
                  compute_dtype="float32")
ROUNDS = 36
TARGET = 0.15   # held-out token accuracy (chain optimum ~0.75)

# stream the cohort in chunks of 2 clients through the flat-buffer fold,
# over the paper-accounting f32 wire, fully synchronous rounds
ENGINE = dict(cohort_chunk=2, agg_engine="flat", comm_dtype="float32",
              async_lag=0)
ALGORITHMS = ("fedhen", "noside", "decouple")


def fed_config(algorithm: str, rounds: int = ROUNDS) -> FedConfig:
    return FedConfig(n_devices=20, n_simple=10, participation=0.2,
                     rounds=rounds, local_epochs=1, lr=0.1, batch_size=8,
                     algorithm=algorithm, seed=0, **ENGINE)


def shards(fed: FedConfig) -> list:
    """The clients' token shards (numpy, as ``iid_split`` returns them)."""
    return iid_split(synthetic_lm(400, 32, CFG.vocab_size, seed=1),
                     fed.n_devices, seed=2)


def test_batch() -> dict:
    return {"tokens": synthetic_lm(64, 32, CFG.vocab_size,
                                   seed=99)["tokens"]}


def run(algorithm: str, rounds: int = ROUNDS, telemetry=None,
        device="cuda") -> dict:
    fed = fed_config(algorithm, rounds)
    client_data = [{"tokens": torch.as_tensor(s["tokens"])}
                   for s in shards(fed)]
    trainer = FederatedTrainer(LMAdapter(CFG), fed, client_data,
                               device=device, telemetry=telemetry)
    test = {"tokens": torch.as_tensor(test_batch()["tokens"]).to(
        trainer.device)}
    history = trainer.run(rounds, eval_every=2, test_batch=test)
    r = rounds_to_target(history, "acc_simple", TARGET)
    final = [h for h in history if "acc_simple" in h][-1]
    return {"algorithm": algorithm, "rounds_to_target": r,
            "final_acc_simple": final["acc_simple"],
            "final_acc_complex": final["acc_complex"],
            "mbytes": trainer.total_bytes / 1e6}


def table(results: list, rounds: int) -> str:
    """The rounds-to-target table, with FedHeN's gain over the best
    baseline when both reached the target."""
    hdr = f"{'algorithm':10s} {'rounds->tgt':>11s} {'simple':>8s} " \
          f"{'complex':>8s} {'comm MB':>9s}"
    lines = [hdr, "-" * len(hdr)]
    for r in results:
        rt = r["rounds_to_target"]
        lines.append(f"{r['algorithm']:10s} "
                     f"{rt if rt > 0 else '>' + str(rounds):>11} "
                     f"{r['final_acc_simple']:8.3f} "
                     f"{r['final_acc_complex']:8.3f} {r['mbytes']:9.1f}")
    best_baseline = min((r["rounds_to_target"] for r in results[1:]
                         if r["rounds_to_target"] > 0), default=-1)
    fh = results[0]["rounds_to_target"]
    if fh > 0 and best_baseline > 0:
        lines.append(f"\nFedHeN communication gain vs best baseline: "
                     f"{best_baseline / fh:.2f}x  (paper reports 1.1-3.3x)")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--telemetry-out", default="",
                    help="write the fedhen run's event stream as JSONL "
                         "here (render with python -m "
                         "repro_torch.obs.report)")
    args = ap.parse_args(argv)
    tel = (obslib.Telemetry([obslib.JsonlSink(args.telemetry_out)])
           if args.telemetry_out else None)
    print(f"target: simple-model accuracy >= {TARGET} "
          f"(rounds to target, lower is better)\n")
    # one event stream per run: only the fedhen leg is instrumented
    results = [run(a, rounds=args.rounds,
                   telemetry=tel if a == "fedhen" else None,
                   device=args.device) for a in ALGORITHMS]
    if tel is not None:
        tel.close()
    print(table(results, args.rounds))
    return results


if __name__ == "__main__":
    main()

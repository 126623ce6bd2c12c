"""The paper's own setting on the PyTorch port: PreActResNet18 (GroupNorm)
complex model, first-2-stages + mix-pool simple model, federated over
heterogeneous clients on CIFAR-shaped data (non-IID Dirichlet split).

The counterpart of ``examples/federated_cifar.py``: the same training flags
through ``repro_torch.launch.train``.  The full 11.2M/0.7M model pair; on
the CPU a handful of rounds takes minutes.

Run:  PYTHONPATH=src python examples/federated_cifar_torch.py [rounds]
      [--device cpu]     (``--device`` defaults to ``cuda``)
"""

import argparse

from repro_torch.launch.train import main


def argv(rounds: str = "3", device: str = "cuda") -> list:
    """The training command line's flags: the flat-buffer fold streamed
    in chunks of 2 clients, the f32 (paper-accounting) wire, synchronous
    rounds.  Swap ``--comm-dtype`` to int8 for the quantized wire, or add
    ``--async-lag 1`` for bounded-lag async rounds."""
    return ["--model", "resnet", "--algorithm", "fedhen",
            "--rounds", rounds, "--clients", "8", "--participation", "0.25",
            "--local-epochs", "1", "--batch-size", "32",
            "--data-points", "1024", "--non-iid", "--eval-every", "1",
            "--cohort-chunk", "2", "--agg-engine", "flat",
            "--comm-dtype", "float32", "--async-lag", "0",
            "--device", device]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rounds", nargs="?", default="3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(argv(args.rounds, args.device))

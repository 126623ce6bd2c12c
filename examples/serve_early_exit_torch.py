"""Serve a small model with batched requests and FedHeN early-exit
decoding, on the PyTorch port.

The counterpart of ``examples/serve_early_exit.py``: the side objective
trains the exit head jointly with the full model, so one checkpoint serves
two quality/latency operating points; the adaptive mode exits early
whenever the exit head is confident (Kaya et al. 2019).

Run:  PYTHONPATH=src python examples/serve_early_exit_torch.py
      [--device cpu]     (``--device`` defaults to ``cuda``)
"""

import argparse

from repro_torch.launch.serve import main

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(["--arch", "gemma2-2b", "--reduced", "--batch", "8",
          "--prompt-len", "32", "--gen", "24",
          "--adaptive-threshold", "0.5", "--device", args.device])

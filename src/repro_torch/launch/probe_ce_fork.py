"""Why the ResNet keeps its own cross-entropy form: its uploads, card
against CPU, under each form.

Runs ``chip_smoke.py``'s phase-5 round (one narrow fedhen round of
PreActResNet18-GN at widths (8, 16, 16, 16) on 16 x 16 synthetic CIFAR, 4
clients, the compressed wire of :data:`profile_round.COMPRESSED`) with the
ResNet's loss in PyTorch's fused ``F.cross_entropy``
(``adapters._resnet_ce``) and in the reference's formula
(``common.softmax_cross_entropy``): twice on the card and once on the CPU
for each form.  Records every client's upload delta (``d`` as the
encoder gets it) and prints, per upload, the largest difference from the
CPU's and the number of elements outside rtol 1e-4 / atol 1e-5 with the
leaves they fall in; the card's run-to-run difference; and, on the CPU,
how far the two forms move each upload.  The last line is one JSON
object with the same numbers.

    PYTHONPATH=src python -m repro_torch.launch.probe_ce_fork [--device cpu]

With ``--device cpu`` only the CPU runs (the forms against each other).
"""

from __future__ import annotations

import argparse
import json
from collections import Counter

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import adapters, federated
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data.federated import iid_split
from repro_torch.data.synthetic import synthetic_cifar
from repro_torch.launch.profile_round import COMPRESSED
from repro_torch.models import common

FORMS = {"fused": adapters._resnet_ce,
         "reference": common.softmax_cross_entropy}


def uploads(device: str, form: str) -> tuple:
    """One phase-5 round on ``device`` with the ResNet's CE in ``form``:
    every upload's ``(identity, d)`` (``d`` on the CPU) and the layout."""
    shards = iid_split(synthetic_cifar(32, 10, seed=0, image_size=16), 4,
                       seed=1)
    fed = FedConfig(n_devices=4, n_simple=2, participation=1.0,
                    local_epochs=1, batch_size=4, algorithm="fedhen",
                    **COMPRESSED)
    inner, ce = federated._encode_upload, adapters._resnet_ce
    seen = []

    def record(up, d, bits):
        seen.append((None if bits is None else list(bits.args[1:]),
                     d.detach().to("cpu", torch.float32).clone()))
        return inner(up, d, bits)

    federated._encode_upload, adapters._resnet_ce = record, FORMS[form]
    try:
        t = FederatedTrainer(
            adapters.ResNetAdapter(10, (8, 16, 16, 16)), fed, shards,
            device=device)
        t.run_round()
    finally:
        federated._encode_upload, adapters._resnet_ce = inner, ce
    return seen, t.layout


def compare(a: list, b: list, layout) -> list:
    """Per upload: the largest |a - b|, and the elements outside rtol 1e-4
    / atol 1e-5 of ``b`` counted by leaf (index and shape)."""
    rows = []
    for (who, x), (_, y) in zip(a, b):
        diff = (x - y).abs()
        out = (diff > 1e-5 + 1e-4 * y.abs()).nonzero().flatten().tolist()
        leaves = Counter()
        for p in out:
            i = next(i for i, s in enumerate(layout.slots)
                     if s.offset <= p < s.offset + s.size)
            leaves[f"{i} {tuple(layout.slots[i].shape)}"] += 1
        rows.append({"client": who, "max_abs": float(diff.max()),
                     "outside": len(out), "leaves": dict(leaves)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (card runs against the CPU) or 'cpu'")
    args = ap.parse_args(argv)
    cpu = {form: uploads("cpu", form) for form in FORMS}
    report = {"cpu_reference_vs_fused": compare(
        cpu["reference"][0], cpu["fused"][0], cpu["fused"][1])}
    for row in report["cpu_reference_vs_fused"]:
        print(f"CPU, reference form against fused: {json.dumps(row)}",
              flush=True)
    if args.device != "cpu":
        from repro_torch.device import resolve_device
        resolve_device(args.device)
        for form in FORMS:
            (first, layout), (second, _) = (uploads(args.device, form)
                                            for _ in range(2))
            rows = compare(first, cpu[form][0], layout)
            again = max(float((x - y).abs().max())
                        for (_, x), (_, y) in zip(first, second))
            for row in rows:
                print(f"{form} form, card against CPU: {json.dumps(row)}",
                      flush=True)
            print(f"{form} form: the card's second run differs from its "
                  f"first by at most {again:.3e}", flush=True)
            report[form] = {"card_vs_cpu": rows, "card_run_to_run": again}
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()

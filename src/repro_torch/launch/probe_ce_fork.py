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
how far the two forms move each upload.

Then, for the client whose card upload lies farthest from the CPU's under
the reference's form, it replays that client's local SGD steps from the
CPU run's inputs (the decoded broadcast it trained on, its data, its
minibatch order), under each CE form: each step's forward and backward
runs on the CPU and on the card from the same params and minibatch, every
ATen op's outputs recorded (``TorchDispatchMode``), and the two op
streams are walked side by side.  Per step it prints the loss, each
gradient leaf's largest difference card against CPU (and its elements
outside rtol 1e-4 / atol 1e-5), the first op whose output differs at all
and the first whose output leaves that tolerance (an integer output, such
as a max-pool's indices, counts its unequal elements), and the ops with
the largest differences.  The CPU's step then gives the next step's
params.  The last line is one JSON object with all of it.

    PYTHONPATH=src python -m repro_torch.launch.probe_ce_fork [--device cpu]

With ``--device cpu`` only the CPU runs (the forms against each other).
"""

from __future__ import annotations

import argparse
import json
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import FedConfig
from repro_torch.core import adapters, federated, flatten
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data.federated import iid_split
from repro_torch.data.synthetic import synthetic_cifar
from repro_torch.launch.profile_round import COMPRESSED
from repro_torch.models import common
from repro_torch.optim.sgd import sgd_update
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

FORMS = {"fused": adapters._resnet_ce,
         "reference": common.softmax_cross_entropy}


def uploads(device: str, form: str, trained=None) -> tuple:
    """One phase-5 round on ``device`` with the ResNet's CE in ``form``:
    every upload's ``(identity, d)`` (``d`` on the CPU) and the trainer.
    ``trained``: a dict that gets each client's training inputs, ``(src,
    data, perms)`` on the CPU, under its identity ``[population, slot]``
    (slots train in order, every slot real at participation 1.0)."""
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

    def recording(population, train):
        slot = iter(range(fed.n_devices))

        def run(src, data, perms, *rest):
            to_cpu = lambda t: t.detach().to("cpu").clone()
            trained[(population, next(slot))] = (
                tree_map(to_cpu, src), {k: to_cpu(v) for k, v in
                                        data.items()},
                [torch.as_tensor(q).clone() for q in perms])
            return train(src, data, perms, *rest)
        return run

    federated._encode_upload, adapters._resnet_ce = record, FORMS[form]
    try:
        t = FederatedTrainer(
            adapters.ResNetAdapter(10, (8, 16, 16, 16)), fed, shards,
            device=device)
        if trained is not None:
            t.train_simple = recording("simple", t.train_simple)
            t.train_complex = recording("complex", t.train_complex)
        t.run_round()
    finally:
        federated._encode_upload, adapters._resnet_ce = inner, ce
    return seen, t


class OpRecord(TorchDispatchMode):
    """Every ATen op run while active, with copies of its tensor outputs
    on ``keep_on`` (forward and backward: the mode follows autograd's
    threads)."""

    def __init__(self, keep_on="cpu"):
        super().__init__()
        self.keep_on = keep_on
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((str(func), [
            o.detach().to(self.keep_on, copy=True) for o in outs
            if isinstance(o, torch.Tensor)]))
        return out


def op_diff(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(largest |a - b|, elements outside rtol 1e-4 / atol 1e-5 of b);
    for integer and bool outputs (0 or 1, unequal elements)."""
    if a.shape != b.shape:
        return float("inf"), -1
    if not a.is_floating_point():
        bad = int((a != b).sum())
        return float(bad > 0), bad
    a, b = a.double(), b.double()
    diff = (a - b).abs()
    finite = torch.isfinite(b)
    return (float(diff[finite].max()) if finite.any() else 0.0,
            int((diff > 1e-5 + 1e-4 * b.abs())[finite].sum()))


def step_ops(loss_fn, params, batch, device: str) -> tuple:
    """One step's loss, gradients and ATen op stream on ``device``, from
    CPU ``params`` and ``batch``."""
    p = tree_map(lambda x: x.detach().to(device).requires_grad_(True),
                 params)
    leaves, treedef = tree_flatten(p)
    b = {k: v.to(device) for k, v in batch.items()}
    with OpRecord() as rec:
        loss = loss_fn(p, b)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (float(loss.detach()), [None if g is None else g.detach().cpu()
                          for g in grads], rec.ops, treedef)


def replay(trained: tuple, loss_fn, fed: FedConfig, device: str,
           own: bool) -> tuple:
    """The client's local steps from the CPU run's ``trained`` inputs, on
    the CPU and on ``device``: per step, the losses, the gradient leaves'
    differences and the op streams' walk.  With ``own`` each side takes
    the next step from its own update (the card's on the card), as the
    two runs did; otherwise both take it from the CPU's.  Returns (the
    rows, each side's final params on the CPU)."""
    src, data, perms = trained
    n = next(iter(data.values())).shape[0]
    steps = max(n // fed.batch_size, 1)
    params = card_params = src
    rows = []
    for epoch, perm in enumerate(perms):
        idxs = perm[:steps * fed.batch_size].reshape(steps, fed.batch_size)
        for s, idx in enumerate(idxs):
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            cpu = step_ops(loss_fn, params, batch, "cpu")
            card = step_ops(loss_fn, card_params if own else params, batch,
                            device)
            row = {"epoch": epoch, "step": s, "loss_cpu": cpu[0],
                   "loss_card": card[0], "grads": [], "ops": len(cpu[2]),
                   "first_differing_op": None, "first_op_outside": None}
            for i, (g, h) in enumerate(zip(cpu[1], card[1])):
                if g is not None and h is not None:
                    d, out = op_diff(h, g)
                    row["grads"].append({
                        "leaf": i, "shape": list(g.shape), "max_abs": d,
                        "outside": out, "max_abs_grad":
                        float(g.abs().max())})
            walked = []
            for k, ((name, outs), (name2, outs2)) in enumerate(
                    zip(cpu[2], card[2])):
                if name != name2 or len(outs) != len(outs2):
                    row["op_streams_part"] = {"at": k, "cpu": name,
                                              "card": name2}
                    break
                diffs = [op_diff(y, x) for x, y in zip(outs, outs2)]
                d = max((x for x, _ in diffs), default=0.0)
                out = sum(o for _, o in diffs)
                entry = {"at": k, "op": name, "max_abs": d,
                         "outside": out, "shapes": [list(x.shape)
                                                    for x in outs]}
                walked.append(entry)
                if d > 0 and row["first_differing_op"] is None:
                    row["first_differing_op"] = entry
                if out and row["first_op_outside"] is None:
                    row["first_op_outside"] = entry
            row["largest_ops"] = sorted(
                walked, key=lambda e: -e["max_abs"])[:6]
            rows.append(row)
            params = sgd_update(params, tree_unflatten(cpu[3], cpu[1]),
                                fed.lr, fed.clip_norm)
            if own:     # the card's step on the card, as its run took it
                on = lambda t: None if t is None else t.to(device)
                card_params = tree_map(lambda x: x.cpu(), sgd_update(
                    tree_map(on, card_params),
                    tree_unflatten(card[3], [on(g) for g in card[1]]),
                    fed.lr, fed.clip_norm))
    return rows, params, card_params if own else params


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
    cpu = {}
    for form in FORMS:
        trained = {}
        seen, t = uploads("cpu", form, trained)
        cpu[form] = (seen, t, trained)
    layout = cpu["fused"][1].layout
    report = {"cpu_reference_vs_fused": compare(
        cpu["reference"][0], cpu["fused"][0], layout)}
    for row in report["cpu_reference_vs_fused"]:
        print(f"CPU, reference form against fused: {json.dumps(row)}",
              flush=True)
    if args.device != "cpu":
        from repro_torch.device import resolve_device
        resolve_device(args.device)
        card_inputs = {}
        for form in FORMS:
            card_inputs[form] = {}
            (first, _), (second, _) = (uploads(args.device, form, inputs)
                                       for inputs in (card_inputs[form],
                                                      None))
            rows = compare(first, cpu[form][0], layout)
            again = max(float((x - y).abs().max())
                        for (_, x), (_, y) in zip(first, second))
            for row in rows:
                print(f"{form} form, card against CPU: {json.dumps(row)}",
                      flush=True)
            print(f"{form} form: the card's second run differs from its "
                  f"first by at most {again:.3e}", flush=True)
            report[form] = {"card_vs_cpu": rows, "card_run_to_run": again}
        worst = max(report["reference"]["card_vs_cpu"],
                    key=lambda r: r["max_abs"])["client"]
        # did the worst client's card run start from the CPU run's inputs?
        for form in FORMS:
            (src, data, perms), (src2, data2, perms2) = (
                inputs[tuple(worst)] for inputs in (cpu[form][2],
                                                    card_inputs[form]))
            report[f"inputs_{form}"] = {
                "broadcast_max_abs": max(
                    float((a.double() - b.double()).abs().max())
                    for a, b in zip(tree_flatten(src)[0],
                                    tree_flatten(src2)[0])),
                "data_equal": all(torch.equal(data[k], data2[k])
                                  for k in data),
                "order_equal": all(torch.equal(a, b)
                                   for a, b in zip(perms, perms2))}
            print(f"{form} form, client {worst}: card run's inputs against "
                  f"the CPU run's {json.dumps(report[f'inputs_{form}'])}",
                  flush=True)
    else:
        worst = ["complex", 0]
    # the diverging client's local steps, op by op, card (or, with
    # --device cpu, the CPU again) against the CPU, under each form: from
    # the same inputs each step, then each side on its own trajectory
    report["replayed_client"] = worst
    for form in FORMS:
        _, t, trained = cpu[form]
        loss_fn = (t.adapter.loss_simple if worst[0] == "simple"
                   else t.adapter.loss_side)
        ce = adapters._resnet_ce
        adapters._resnet_ce = FORMS[form]
        try:
            for own in (False, True):
                rows, y_cpu, y_card = replay(trained[tuple(worst)], loss_fn,
                                             t.fed, args.device, own)
                mode = "own trajectories" if own else "same inputs"
                for row in rows:
                    grads = sorted(row["grads"],
                                   key=lambda g: -g["max_abs"])[:4]
                    print(f"{form} form, {mode}, client {worst} step "
                          f"{row['epoch']}.{row['step']}: loss cpu "
                          f"{row['loss_cpu']!r} card {row['loss_card']!r}; "
                          f"{row['ops']} ops; first differing op "
                          f"{json.dumps(row['first_differing_op'])}; first "
                          f"op outside tolerance "
                          f"{json.dumps(row['first_op_outside'])}; largest "
                          f"ops {json.dumps(row['largest_ops'][:3])}; "
                          f"largest grad leaf differences "
                          f"{json.dumps(grads)}", flush=True)
                key = f"replay_{form}_{'own' if own else 'same'}"
                report[key] = {"steps": rows}
                if own:
                    # the replay's trained client against the CPU's
                    src = trained[tuple(worst)][0]
                    d = lambda y: flatten.pack(layout, y) - flatten.pack(
                        layout, src)
                    final = compare([(worst, d(y_card))],
                                    [(worst, d(y_cpu))], layout)[0]
                    report[key]["final"] = final
                    print(f"{form} form, own trajectories: the replayed "
                          f"card client against the CPU's "
                          f"{json.dumps(final)}", flush=True)
        finally:
            adapters._resnet_ce = ce
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()

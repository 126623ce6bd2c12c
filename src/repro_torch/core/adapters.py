"""Model adapters: bind an architecture to the FedHeN machinery.

The port of ``repro.core.adapters.ResNetAdapter``.  An adapter exposes the
paper's three client objectives over a *complex* parameter tree:

* ``loss_complex`` — f_j(w_c)
* ``loss_simple``  — f_i([w_c]_M): touches only M, so PyTorch returns no
  gradient (``None``) outside M, which the optimizer reads as zero
* ``loss_side``    — f_j(w_c) + f_j([w_c]_M), in ONE forward pass

plus ``subnet_mask`` (index set M) and evaluation metrics for both heads.
The LM adapter comes with the LM slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import masking
from repro_torch.models import common, resnet
from repro_torch.tree import Tree, tree_map

Batch = Dict[str, torch.Tensor]


def _ce(logits, labels):
    return common.softmax_cross_entropy(logits, labels)


def _acc(logits, labels):
    return (logits.argmax(-1) == labels.long()).float().mean()


class ResNetAdapter:
    """PreActResNet18-GN complex / 2-stage+mixpool simple (paper §3).
    ``channels`` are the stage widths (the paper's by default)."""

    def __init__(self, n_classes: int = 10,
                 channels: Sequence[int] = resnet.STAGE_CHANNELS):
        self.n_classes = n_classes
        self.channels = tuple(channels)

    def init(self, generator: torch.Generator, device) -> Tree:
        """Params drawn on the CPU from ``generator``, then moved to
        ``device`` — the same seed gives the same weights on every
        device."""
        params = resnet.init_params(generator, self.n_classes, self.channels)
        return tree_map(lambda x: x.to(device), params)

    def subnet_mask(self, params: Tree) -> Tree:
        return masking.resnet_subnet_mask(params)

    def loss_complex(self, params: Tree, batch: Batch) -> torch.Tensor:
        _, final = resnet.forward(params, batch["images"])
        return _ce(final, batch["labels"])

    def loss_simple(self, params: Tree, batch: Batch) -> torch.Tensor:
        logits = resnet.forward_simple(params, batch["images"])
        return _ce(logits, batch["labels"])

    def loss_side(self, params: Tree, batch: Batch) -> torch.Tensor:
        exit_logits, final = resnet.forward(params, batch["images"])
        return _ce(final, batch["labels"]) + _ce(exit_logits, batch["labels"])

    @torch.no_grad()
    def evaluate(self, params: Tree, batch: Batch) -> Dict[str, torch.Tensor]:
        exit_logits, final = resnet.forward(params, batch["images"])
        return {"acc_complex": _acc(final, batch["labels"]),
                "acc_simple": _acc(exit_logits, batch["labels"])}

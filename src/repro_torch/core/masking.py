"""Index set M (FedHeN Assumption 2.1) as broadcastable mask trees.

The port of the ResNet part of ``repro.core.masking``: a mask tree has the
parameter tree's structure, and each leaf is a Python bool marking the
whole leaf in or out of M (``flatten.pack_mask`` lowers it to one flat
bitvector).  The trainer keeps one more form, built once on its device:
``flatten.unpack(layout, flat_mask, cast=False)``, a tree of full-shape
bool views of that bitvector — the per-leaf masks of the tree engine.
"""

from __future__ import annotations

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map

SIMPLE_KEYS = ("stem", "stage1", "stage2", "exit_head")


def resnet_subnet_mask(params: Tree) -> Tree:
    """M for the ResNet: stem + stage1 + stage2 + exit head."""
    return {name: tree_map(lambda _, keep=name in SIMPLE_KEYS: keep, sub)
            for name, sub in params.items()}


def tree_isfinite(tree: Tree) -> torch.Tensor:
    """0-d bool tensor: every floating leaf fully finite (the paper's
    NaN-device check).  Stays on the tree's device: no host sync."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree)
             if x.is_floating_point()]
    return torch.stack(flags).all() if flags else torch.tensor(True)


def where_mask(mask: Tree, a: Tree, b: Tree) -> Tree:
    """Leafwise ``mask ? a : b`` (mask leaves: bools or bool tensors
    broadcastable to their leaf)."""
    return tree_map(lambda m, x, y: torch.where(
        torch.as_tensor(m, dtype=torch.bool, device=x.device), x, y),
        mask, a, b)

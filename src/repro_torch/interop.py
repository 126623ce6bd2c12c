"""Carry parameters between the reference and the port.

The input is the nested dict/list tree of numpy arrays that
``jax.tree.map(np.asarray, params)`` gives for the reference's params (the
caller makes it; the port never sees JAX).  The port keeps the reference's
leaf shapes — conv kernels stay HWIO and are permuted at each conv call
(:func:`repro_torch.models.resnet.conv2d`) — so a conversion is a copy of
each leaf and nothing else, and :func:`to_reference` is its exact
inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import Tree, tree_map


def from_reference(tree: Tree, device="cpu") -> Tree:
    """Numpy tree of the reference -> the port's tree of tensors."""
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=device),
                    tree)


def to_reference(tree: Tree) -> Tree:
    """The port's tree of tensors -> numpy tree in the reference's layout."""
    return tree_map(lambda x: x.detach().cpu().numpy().copy(), tree)

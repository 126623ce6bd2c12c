"""Carry parameters between the reference and the port.

The input is the nested dict/list tree of numpy arrays that
``jax.tree.map(np.asarray, params)`` gives for the reference's params (the
caller makes it; the port never sees JAX).  The port keeps the reference's
leaf shapes — conv kernels stay HWIO and are permuted at each conv call
(:func:`repro_torch.models.resnet.conv2d`), the transformer's stacked
``periods`` leaves keep their leading axis — so a conversion is a copy of
each leaf and nothing else, and :func:`to_reference` is its exact
inverse.

bf16 leaves (numpy dtype ``bfloat16`` from ``ml_dtypes``, which JAX
brings) cannot go through ``torch.tensor``; they cross as their 16-bit
patterns and are reinterpreted on the other side, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import Tree, tree_map


def _to_tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(x).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(x, device=device)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        # numpy knows "bfloat16" once ml_dtypes is imported (JAX imports it)
        return x.view(torch.int16).numpy().copy().view(np.dtype("bfloat16"))
    return x.numpy().copy()


def from_reference(tree: Tree, device="cpu") -> Tree:
    """Numpy tree of the reference -> the port's tree of tensors."""
    return tree_map(lambda x: _to_tensor(x, device), tree)


def to_reference(tree: Tree) -> Tree:
    """The port's tree of tensors -> numpy tree in the reference's layout."""
    return tree_map(_to_numpy, tree)

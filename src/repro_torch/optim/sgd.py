"""Plain SGD with global-norm clipping — the paper's client optimizer
(eta = 0.1, clip 10; Appendix A).  The port of ``repro.optim.sgd``.

A gradient leaf may be ``None``: PyTorch leaves ``.grad`` unset for a
parameter the loss does not touch (``loss_simple`` touches only M), where
JAX returns zeros.  Every function here treats ``None`` as a zero
gradient, so such a parameter comes back unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every (non-``None``) leaf, in f32."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)
            if x is not None]
    if not sums:
        return torch.zeros(())
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: None if g is None
                    else (g.float() * scale).to(g.dtype), grads), norm


def sgd_update(params: Tree, grads: Tree, lr: float,
               clip_norm: Optional[float] = None) -> Tree:
    """w <- w - lr * clip(g).  Arithmetic in f32, stored in param dtype; a
    ``None`` gradient leaves its parameter as it is."""
    if clip_norm:
        grads, _ = clip_by_global_norm(grads, clip_norm)
    return tree_map(
        lambda w, g: w if g is None
        else (w.float() - lr * g.float()).to(w.dtype), params, grads)
